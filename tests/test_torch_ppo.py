"""The port's actor-critic and PPO (``repro_torch.rl.nets``,
``repro_torch.rl.ppo``) against the JAX package run live.

Tolerances, stated per check:

- ``ActorCritic.init`` draws through ``random.normal``, which is held to
  the JAX package's to rtol 1e-3 / atol 1e-6 (tests/test_torch_random.py;
  here every weight agrees to atol 1e-6);
- ``forward``, ``sample`` and ``logp_entropy`` on the same weights agree
  to 1e-5 (the convs and matmuls sum in another order);
- discrete actions are equal: both draw by Gumbel-max from the same
  key, and the port's ``gumbel`` differs from XLA's in the last bit on
  about a quarter of draws (ROADMAP C.3), which could flip an action only
  at a near tie of two logits plus noise, as none of these draws is;
- one ``make_ppo_update`` call on a fixed rollout: loss and metrics to
  1e-5 relative and absolute, params and AdamW moments to 1e-6;
- ``train_device`` end to end, 2 iterations: the same episode counts,
  losses and metrics to 1e-4 relative (a ratio near 1 and losses whose
  terms cancel), final params to 1e-5 absolute.  Ant's actions carry
  ``normal``'s tolerance and its physics XLA's ``cos``, so its rollout
  agrees to 1e-4, as in tests/test_torch_pool.py.

The 32 updates of 2 default iterations can set two f32 runs apart:
once a ReLU whose input sits at zero opens under one summation order
and not the other, Adam moves the weights apart by up to the learning
rate a step.  Whether it happens depends on the seed and the size, not
on the package: scripts/train_sensitivity.py shows the port alone,
with the CPU's oneDNN convs and without, part so at some seeds and
sizes.  At 2 of 4 Pong lanes and seed 3 the two packages part so within
the first iteration's four epochs, so the default-config run serves 4
of 8 lanes there, and the four-update runs, which stay at rounding,
cover 2 of 4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.rl.nets as jnets  # noqa: E402
import repro.rl.ppo as jppo  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.rl import nets as tnets  # noqa: E402
from repro_torch.rl import ppo as tppo  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402

HIDDEN = (32, 32)


def pools(task, n, m=None):
    jp = jax_registry.make(task, num_envs=n, batch_size=m, obs=False,
                           max_episode_steps=5)
    tp = repro_torch.make(task, num_envs=n, batch_size=m, device="cpu",
                          max_episode_steps=5)
    return jp, tp


def nets(task, hidden=HIDDEN):
    jp, tp = pools(task, 4)
    return (jnets.ActorCritic(jp.spec, hidden),
            tnets.ActorCritic(tp.spec, hidden))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_params_close(tparams, jparams, atol, rtol=0.0):
    """The port's params against the JAX package's, through
    ``params_from_jax`` (conv weights to OIHW)."""
    want = dict(tree_leaves_with_path(tnets.params_from_jax(
        to_np(jparams), "cpu")))
    got = dict(tree_leaves_with_path(tparams))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=rtol, atol=atol, err_msg=path)


def obs_batch(spec, n, seed):
    rng = np.random.default_rng(seed)
    shape = (n,) + spec.obs_spec.shape
    if spec.obs_spec.dtype == torch.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("task,hidden", [
    ("PongClassic-v5", HIDDEN), ("Ant-v3", HIDDEN),
    ("Ant-v3", (256, 128, 64)),
])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_matches_repro(task, hidden, seed):
    jn, tn = nets(task, hidden)
    assert (tn.pixel, tn.discrete, tn.act_dim) == (jn.pixel, bool(
        jn.discrete), jn.act_dim)
    jparams = jn.init(jax.random.PRNGKey(seed))
    tparams = tn.init(R.PRNGKey(seed))
    if tn.pixel:
        assert tuple(tparams["conv1"]["w"].shape) == (32, 4, 8, 8)
        assert tuple(tparams["fc"]["w"].shape) == (3136, 512)
    assert_params_close(tparams, jparams, atol=1e-6)


def test_params_from_jax_layout():
    """Conv weights move from HWIO to OIHW; every other leaf, ``fc.w``
    included, keeps its layout."""
    jn, _ = nets("PongClassic-v5")
    jparams = to_np(jn.init(jax.random.PRNGKey(1)))
    tparams = tnets.params_from_jax(jparams, "cpu")
    for name in ("conv1", "conv2", "conv3"):
        np.testing.assert_array_equal(
            tparams[name]["w"].numpy(),
            jparams[name]["w"].transpose(3, 2, 0, 1))
        assert tparams[name]["w"].is_contiguous()
    for name in ("fc", "pi", "v"):
        np.testing.assert_array_equal(tparams[name]["w"].numpy(),
                                      jparams[name]["w"])


def test_trunk_flattens_in_nhwc_order():
    """A ``fc.w`` row picks one (h, w, c) feature of conv3's output in
    the JAX package's NHWC order: the trunks agree only if the port
    flattens the same way."""
    jn, tn = nets("PongClassic-v5")
    jparams = to_np(jn.init(jax.random.PRNGKey(2)))
    fc = np.zeros_like(jparams["fc"]["w"])
    h, w, c = 3, 5, 17
    fc[(h * 7 + w) * 64 + c, 0] = 1.0
    jparams["fc"]["w"] = fc
    obs = obs_batch(tn.spec, 3, 7)
    want = np.asarray(jn.trunk(jparams, jnp.asarray(obs)))
    got = tn.trunk(tnets.params_from_jax(jparams, "cpu"),
                   torch.from_numpy(obs)).numpy()
    assert np.abs(want[:, 0]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", ["PongClassic-v5", "Ant-v3"])
def test_forward_sample_logp_match_repro(task):
    jn, tn = nets(task)
    jparams = jn.init(jax.random.PRNGKey(3))
    tparams = tnets.params_from_jax(to_np(jparams), "cpu")
    obs = obs_batch(tn.spec, 16, 4)
    tol = dict(rtol=1e-5, atol=1e-5)
    for name, j, t in zip(("pi", "v"), jn.forward(jparams, jnp.asarray(obs)),
                          tn.forward(tparams, torch.from_numpy(obs))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **tol)
    for k in range(4):
        ja = jn.sample(jparams, jnp.asarray(obs), jax.random.PRNGKey(10 + k))
        ta = tn.sample(tparams, torch.from_numpy(obs), R.PRNGKey(10 + k))
        if tn.discrete:
            assert ta[0].dtype == torch.int32
            np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
        else:
            np.testing.assert_allclose(ta[0].numpy(), np.asarray(ja[0]),
                                       **tol)
        for name, t, j in zip(("logp", "v", "ent"), ta[1:], ja[1:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=name, **tol)
    acts = np.asarray(ja[0])
    jl = jn.logp_entropy(jparams, jnp.asarray(obs), jnp.asarray(acts))
    tl = tn.logp_entropy(tparams, torch.from_numpy(obs),
                         torch.from_numpy(acts))
    for name, t, j in zip(("logp", "ent", "v"), tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **tol)


def test_clip_splits_the_gradient_at_a_bound_as_jnp_clip():
    x = np.array([0.7, 0.8, 1.0, 1.2, 1.3], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.8, 1.2)))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    tppo._clip(t, 0.8, 1.2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])


def fixed_rollout(spec, T, M, act_dim, discrete, seed):
    rng = np.random.default_rng(seed)
    obs = obs_batch(spec, T * M, seed).reshape((T, M) + spec.obs_spec.shape)
    if discrete:
        actions = rng.integers(0, act_dim, (T, M)).astype(np.int32)
    else:
        actions = rng.normal(0, 1, (T, M, act_dim)).astype(np.float32)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return {"obs": obs, "actions": actions, "logp": f(T, M) - 2.0,
            "values": f(T, M), "adv": f(T, M), "ret": f(T, M)}


@pytest.mark.parametrize("task", ["PongClassic-v5", "Ant-v3"])
@pytest.mark.parametrize("vf_clip", [True, False])
def test_ppo_update_matches_repro(task, vf_clip):
    jn, tn = nets(task)
    cfg = dict(num_steps=4, epochs=2, minibatches=2, vf_clip=vf_clip)
    jcfg, tcfg = jppo.PPOConfig(**cfg), tppo.PPOConfig(**cfg)
    jopt, jupd = jppo.make_ppo_update(jn, jcfg, 16)
    topt, tupd = tppo.make_ppo_update(tn, tcfg, 16)
    jparams = jn.init(jax.random.PRNGKey(0))
    tparams = tnets.params_from_jax(to_np(jparams), "cpu")
    jstate = jppo.PPOState(jparams, jopt.init(jparams), jnp.int32(0))
    tstate = tppo.PPOState(tparams, topt.init(tparams),
                           torch.zeros((), dtype=torch.int32))
    roll = fixed_rollout(tn.spec, 4, 6, tn.act_dim, tn.discrete, 1)
    jstate, jm = jax.jit(jupd)(jstate, jax.tree.map(jnp.asarray, roll),
                               jax.random.PRNGKey(2))
    tstate, tm = tupd(tstate, {k: torch.from_numpy(v)
                               for k, v in roll.items()}, R.PRNGKey(2))
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert int(tstate.step) == int(jstate.step) == 4
    assert int(tstate.opt.count) == int(jstate.opt.count) == 4
    assert_params_close(tstate.params, jstate.params, atol=1e-6)
    for name in ("mu", "nu"):
        jtree = getattr(jstate.opt, name)
        want = dict(tree_leaves_with_path(tnets.params_from_jax(
            to_np(jtree), "cpu")))
        for path, leaf in tree_leaves_with_path(getattr(tstate.opt, name)):
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{path}")


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, None), ("Ant-v3", 8, 4), ("PongClassic-v5", 4, None),
    ("PongClassic-v5", 8, 4),
])
def test_train_device_matches_repro(task, n, m):
    jp, tp = pools(task, n, m)
    M = m or n
    cfg = dict(total_steps=2 * 8 * M, num_steps=8)
    js, _, jh = jppo.train_device(jp, jppo.PPOConfig(**cfg), seed=3,
                                  hidden=HIDDEN)
    logged = []
    ts, tnet, th = tppo.train_device(tp, tppo.PPOConfig(**cfg), seed=3,
                                     hidden=HIDDEN, log_fn=logged.append)
    assert logged == th and len(th) == len(jh) == 2
    for jr, tr in zip(jh, th):
        assert tr.keys() == jr.keys()
        for k in ("iter", "env_steps", "episodes"):
            assert tr[k] == jr[k], k
        for k in ("loss", "pg", "vf", "ent", "ratio", "mean_return"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"iter {tr['iter']} {k}")
    assert sum(r["episodes"] for r in th) > 0
    assert int(ts.step) == int(js.step) == 2 * 4 * 4
    assert_params_close(ts.params, js.params, atol=1e-5)


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, 4), ("PongClassic-v5", 4, None), ("PongClassic-v5", 4, 2),
])
def test_train_device_four_updates_match_repro(task, n, m):
    """Two iterations of one epoch of two minibatches: four updates, too
    few for a ReLU at zero to set the runs apart, so the params agree to
    1e-6 and the losses to 1e-5 relative even at 2 of 4 lanes; ``pg``
    is a mean of ``adv * ratio`` terms of size 1 (``ratio`` carrying
    logp's 1e-6) that cancel to 1e-4, so it is held to 1e-5 absolute."""
    jp, tp = pools(task, n, m)
    cfg = dict(total_steps=2 * 8 * (m or n), num_steps=8, epochs=1,
               minibatches=2)
    js, _, jh = jppo.train_device(jp, jppo.PPOConfig(**cfg), seed=3,
                                  hidden=HIDDEN)
    ts, _, th = tppo.train_device(tp, tppo.PPOConfig(**cfg), seed=3,
                                  hidden=HIDDEN)
    for jr, tr in zip(jh, th):
        assert tr["episodes"] == jr["episodes"]
        for k in ("loss", "vf", "ent", "ratio"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"iter {tr['iter']} {k}")
        np.testing.assert_allclose(tr["pg"], jr["pg"], rtol=0, atol=1e-5,
                                   err_msg=f"iter {tr['iter']} pg")
    assert int(ts.step) == int(js.step) == 4
    assert_params_close(ts.params, js.params, atol=1e-6)


def test_train_device_refuses_what_is_not_ported():
    """``train_device`` on a host pool names ``train_host``, which runs
    on one (tests/test_torch_train_host.py holds it to ``repro``'s); the
    disaggregated trainer needs a job of two processes or more
    (tests/test_torch_disaggregated.py holds it to ``repro``'s)."""
    host = repro_torch.make("CartPole-v1", num_envs=4, engine="forloop",
                            device="cpu")
    with pytest.raises(ValueError, match="train_host"):
        tppo.train_device(host, tppo.PPOConfig())
    state, _, history, prof = tppo.train_host(
        host, cfg=tppo.PPOConfig(total_steps=8, num_steps=2, epochs=1,
                                 minibatches=1),
        hidden=(8,), device="cpu")
    assert int(state.step) == 1 and len(history) == 1
    assert set(prof) == {"env_step", "inference", "train", "other"}
    with pytest.raises(ValueError, match=">= 2 processes"):
        tppo.train_disaggregated(None, tppo.PPOConfig())


@pytest.mark.parametrize("task,n,engine", [
    ("Ant-v3", 8, "device"), ("PongClassic-v5", 4, "device"),
    ("Ant-v3", 8, "forloop"), ("CartPole-v1", 8, "forloop"),
])
def test_train_dispatches_as_repro(task, n, engine):
    """``train`` runs ``train_device`` on the device engine and
    ``train_host`` on a host engine, as ``repro``'s does: one iteration
    at ``test_train_device_matches_repro``'s tolerances (losses within
    1e-4 relative, params within 1e-5; 1e-4 for Ant over a host engine,
    whose rollout carries 1e-4, tests/test_torch_train_host.py)."""
    kw = dict(num_envs=n, engine=engine, max_episode_steps=5)
    jp = jax_registry.make(task, obs=False, **kw)
    tp = repro_torch.make(task, device="cpu", **kw)
    cfg = dict(total_steps=8 * n, num_steps=8)
    try:
        js, _, jh = jppo.train(jp, jppo.PPOConfig(**cfg), seed=3,
                               hidden=HIDDEN)
        ts, tnet, th = tppo.train(tp, tppo.PPOConfig(**cfg), seed=3,
                                  hidden=HIDDEN)
    finally:
        if engine != "device":
            jp.close()
            tp.close()
    assert isinstance(tnet, tnets.ActorCritic)
    assert len(th) == len(jh) == 1
    jr, tr = jh[0], th[0]
    assert tr.keys() == jr.keys()
    for k in ("iter", "env_steps", "episodes"):
        assert tr[k] == jr[k], k
    for k in ("loss", "pg", "vf", "ent", "ratio", "mean_return"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert int(ts.step) == int(js.step) == 16
    atol = 1e-4 if (task, engine) == ("Ant-v3", "forloop") else 1e-5
    assert_params_close(ts.params, js.params, atol=atol)
