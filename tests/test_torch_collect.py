"""The port's collect loop (``repro_torch.core.xla_loop``) against the JAX
package's jitted ``lax.scan`` run live, and ``ArraySpec.sample``
against ``sample_jax``.

A scripted policy acts from the step's key and the served obs, the same
in both packages: Pong takes ``randint(key) + a pixel of the newest
frame`` mod 6, Ant ``uniform(key) / 2`` plus half the first 8 obs
clipped to [-1, 1].  ids, done, terminated, truncated, step_cost and
Pong's obs and reward are bitwise; Ant's obs, reward and actions are
held to atol 1e-4, as tests/test_torch_pool.py holds Ant (XLA's fused
multiply-adds and ``cos`` differ from torch's in the last bit, and the
physics carries it on).  ``ArraySpec.sample`` and the random collect's
actions are bitwise.  The pipelined collect acts through the
actor-critic on the same weights in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.core.xla_loop as jloop  # noqa: E402
import repro.rl.nets as jnets  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.specs import ArraySpec as JArraySpec  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import xla_loop as tloop  # noqa: E402
from repro_torch.core.specs import ArraySpec  # noqa: E402
from repro_torch.rl import nets as tnets  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

STEPS = 12
EXACT = ("env_id", "done", "terminated", "truncated", "step_cost",
         "episode_length")


def pools(task, n, m, schedule="fifo"):
    jp = jax_registry.make(task, num_envs=n, batch_size=m, schedule=schedule,
                           obs=False, max_episode_steps=5)
    tp = repro_torch.make(task, num_envs=n, batch_size=m, schedule=schedule,
                          device="cpu", max_episode_steps=5)
    return jp, tp


def jax_policy(continuous):
    def policy(params, obs, key):
        m = obs.shape[0]
        if continuous:
            return (jax.random.uniform(key, (m, 8), jnp.float32, -1.0, 1.0)
                    * 0.5 + 0.5 * jnp.clip(obs[:, :8], -1.0, 1.0))
        pixel = obs[:, -1, 40, params].astype(jnp.int32)
        return (jax.random.randint(key, (m,), 0, 6) + pixel) % 6

    return policy


def torch_policy(continuous):
    def policy(params, obs, key):
        m = obs.shape[0]
        if continuous:
            return (R.uniform(key, (m, 8), -1.0, 1.0) * 0.5
                    + 0.5 * torch.clamp(obs[:, :8], -1.0, 1.0))
        pixel = obs[:, -1, 40, params].to(torch.int32)
        return (R.randint(key, (m,), 0, 6) + pixel) % 6

    return policy


def compare_traj(task, jtraj, ttraj, jacts, tacts, atol):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(ttraj, f).numpy(),
                                      np.asarray(getattr(jtraj, f)),
                                      err_msg=f"{task} {f}")
    pairs = [(f, getattr(ttraj, f).numpy(), np.asarray(getattr(jtraj, f)))
             for f in ("obs", "reward", "episode_return")]
    pairs.append(("actions", tacts.numpy(), np.asarray(jacts)))
    for f, got, want in pairs:
        assert got.shape == want.shape, f
        if atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f"{task} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{task} {f}")


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, None), ("Ant-v3", 8, 4),
    ("PongClassic-v5", 4, None), ("PongClassic-v5", 4, 2),
])
def test_collect_matches_repro(task, n, m):
    continuous = task.startswith("Ant")
    atol = 1e-4 if continuous else 0.0
    jp, tp = pools(task, n, m)
    jps, jts = jloop.collect_init(jp, jax.random.PRNGKey(0))
    tps, tts = tloop.collect_init(tp, R.PRNGKey(0))
    jcol = jloop.build_collect_fn(jp, jax_policy(continuous), STEPS)
    tcol = tloop.build_collect_fn(tp, torch_policy(continuous), STEPS)
    params = 50
    # two collects, so the second starts from the first's state
    for k in (5, 6):
        jps, jts, jtraj, jacts = jcol(jps, params, jts, jax.random.PRNGKey(k))
        tps, tts, ttraj, tacts = tcol(tps, params, tts, R.PRNGKey(k))
        assert ttraj.obs.shape == (STEPS,) + jtraj.obs.shape[1:]
        assert bool(np.asarray(jtraj.done).any())
        compare_traj(f"{task} key {k}", jtraj, ttraj, jacts, tacts, atol)
    compare_traj(task, jax.tree.map(lambda x: x[None], jts),
                 tree_map(lambda x: x[None], tts), jacts[:1], tacts[:1],
                 atol)


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, 4), ("PongClassic-v5", 4, None),
])
def test_random_collect_actions_are_bitwise(task, n, m):
    jp, tp = pools(task, n, m)
    jps, jts = jloop.collect_init(jp, jax.random.PRNGKey(1))
    tps, tts = tloop.collect_init(tp, R.PRNGKey(1))
    _, _, jtraj, jacts = jloop.build_random_collect_fn(jp, 6)(
        jps, None, jts, jax.random.PRNGKey(2))
    _, _, ttraj, tacts = tloop.build_random_collect_fn(tp, 6)(
        tps, None, tts, R.PRNGKey(2))
    assert tacts.dtype == tp.spec.act_spec.dtype
    np.testing.assert_array_equal(tacts.numpy(), np.asarray(jacts))
    np.testing.assert_array_equal(ttraj.env_id.numpy(),
                                  np.asarray(jtraj.env_id))


def test_stepwise_collect_matches_collect():
    _, tp = pools("PongClassic-v5", 4, 2)
    out = []
    for build in (tloop.build_collect_fn, tloop.build_stepwise_collect_fn):
        ps, ts = tloop.collect_init(tp, R.PRNGKey(0))
        out.append(build(tp, torch_policy(False), 6)(ps, 30, ts,
                                                     R.PRNGKey(4)))
    (_, ts_a, traj_a, acts_a), (_, ts_b, traj_b, acts_b) = out
    assert torch.equal(acts_a, acts_b)
    assert torch.equal(traj_a.obs, traj_b.obs)
    assert torch.equal(ts_a.obs, ts_b.obs)


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, None), ("PongClassic-v5", 4, 2),
])
def test_frames_per_batch_matches_repro(task, n, m):
    jp, tp = pools(task, n, m)
    assert tloop.frames_per_batch(tp) == jloop.frames_per_batch(jp)


@pytest.mark.parametrize("dtype,lo,hi", [
    ("int32", 0, 5), ("int32", None, None), ("int32", -3, 7),
    ("float32", -1.0, 1.0), ("float32", None, None), ("float32", 0.5, 2.0),
])
@pytest.mark.parametrize("leading", [(), (6,), (2, 3)])
def test_array_spec_sample_is_bitwise(dtype, lo, hi, leading):
    jspec = JArraySpec((4,), np.dtype(dtype), lo, hi)
    tspec = ArraySpec((4,), getattr(torch, dtype), lo, hi)
    want = np.asarray(jspec.sample_jax(jax.random.PRNGKey(9), leading))
    got = tspec.sample(R.PRNGKey(9), leading)
    assert got.dtype == tspec.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_only_the_device_engine_is_ported():
    """``collect_init`` and ``build_collect_fn`` take a host pool too (a
    forloop pool here: tests/test_torch_train_host.py holds its stream
    to ``repro``'s); the stepwise and pipelined collects are for the
    device engine and raise ``ValueError`` on a host pool, as
    ``repro``'s do."""
    host = repro_torch.make("Pong-v5", num_envs=4, engine="forloop",
                            device="cpu", max_episode_steps=5)
    ps, ts = tloop.collect_init(host, R.PRNGKey(0))
    assert ps is None and tuple(ts.obs.shape) == (4, 4, 84, 84)
    ps, ts, traj, acts = tloop.build_collect_fn(
        host, torch_policy(False), 4)(ps, 50, ts, R.PRNGKey(1))
    assert ps is None and tuple(traj.obs.shape) == (4, 4, 4, 84, 84)
    assert tuple(acts.shape) == (4, 4)
    for build in (tloop.build_stepwise_collect_fn,
                  tloop.build_pipelined_collect_fn):
        with pytest.raises(ValueError, match="host engine"):
            build(host, torch_policy(False), 4)


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, None), ("Ant-v3", 8, 4), ("PongClassic-v5", 4, 2),
])
def test_pipelined_collect_matches_repro(task, n, m):
    """Two pipelined collects through the actor-critic on the same
    weights (``params_from_jax``): every rollout leaf and ``last_obs``
    bitwise for Pong but ``logp`` (1e-5, the nets' tolerance,
    tests/test_torch_ppo.py), within 1e-4 for Ant's floats; each call
    allocates a fresh rollout."""
    jp, tp = pools(task, n, m)
    jnet = jnets.ActorCritic(jp.spec, (32, 32))
    tnet = tnets.ActorCritic(tp.spec, (32, 32))
    jparams = jnet.init(jax.random.PRNGKey(1))
    tparams = tnets.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    def jpolicy(p, obs, k):
        a, logp, _, _ = jnet.sample(p, obs, k)
        return a, logp

    def tpolicy(p, obs, k):
        a, logp, _, _ = tnet.sample(p, obs, k)
        return a, logp

    jps, jts = jloop.collect_init(jp, jax.random.PRNGKey(0))
    tps, tts = tloop.collect_init(tp, R.PRNGKey(0))
    jcol = jloop.build_pipelined_collect_fn(jp, jpolicy, STEPS, donate=False)
    tcol = tloop.build_pipelined_collect_fn(tp, tpolicy, STEPS)
    rollouts = []
    for k in (5, 6):
        jps, jts, jroll = jcol(jps, jparams, jts, jax.random.PRNGKey(k))
        with torch.no_grad():
            tps, tts, troll = tcol(tps, tparams, tts, R.PRNGKey(k))
        rollouts.append(troll)
        assert troll.keys() == jroll.keys() == {
            "obs", "actions", "logp", "rewards", "dones", "ep_ret",
            "last_obs"}
        assert bool(np.asarray(jroll["dones"]).any())
        for f, want in jroll.items():
            got = troll[f].numpy()
            want = np.asarray(want)
            assert got.shape == want.shape, f
            assert got.dtype == want.dtype, f
            if f == "logp":
                tol = 1e-4 if task.startswith("Ant") else 1e-5
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                           err_msg=f"{task} key {k} {f}")
            elif task.startswith("Ant") and got.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                           err_msg=f"{task} key {k} {f}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{task} key {k} {f}")
    first, second = (tree_leaves(r) for r in rollouts)
    assert not any(a.untyped_storage().data_ptr()
                   == b.untyped_storage().data_ptr()
                   for a in first for b in second)
