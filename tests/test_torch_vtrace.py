"""The port's V-trace (``repro_torch.rl.vtrace``) and V-trace PPO update
(``repro_torch.rl.ppo.make_vtrace_ppo_update``) against the JAX
package's run live on the same seeded numpy inputs.

Tolerances: ``vtrace`` within rtol 1e-5 / atol 1e-6 (the same f32 ops
in the same order, XLA free to fuse them); on policy with inactive clips
``vs - values`` is GAE's advantage within 1e-4, as tests/test_rl.py
holds ``repro``'s; one update: loss and metrics within 1e-5 as in
``test_ppo_update_matches_repro``, params within 1e-5, not 1e-6: the
update's targets and advantages come from a recompute of the values and
log-probs through the nets, which agree to 1e-5
(tests/test_torch_ppo.py), and four Adam steps carry that over.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.rl.nets as jnets  # noqa: E402
import repro.rl.ppo as jppo  # noqa: E402
from repro.rl.vtrace import vtrace as jax_vtrace  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.rl import nets as tnets  # noqa: E402
from repro_torch.rl import ppo as tppo  # noqa: E402
from repro_torch.rl.gae import gae  # noqa: E402
from repro_torch.rl.vtrace import VTraceReturns, vtrace  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402


def inputs(T, N, seed, off_policy=True):
    rng = np.random.default_rng(seed)
    blogp = rng.normal(scale=0.5, size=(T, N)).astype(np.float32)
    tlogp = (blogp + rng.normal(scale=0.3, size=(T, N)).astype(np.float32)
             if off_policy else blogp)
    return dict(
        behavior_logp=blogp, target_logp=tlogp,
        rewards=rng.normal(size=(T, N)).astype(np.float32),
        values=rng.normal(size=(T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        bootstrap_value=rng.normal(size=N).astype(np.float32))


@pytest.mark.parametrize("T,N,gamma,lam,rho_clip,c_clip,seed", [
    (1, 1, 0.99, 1.0, 1.0, 1.0, 0),
    (5, 3, 0.99, 0.95, 1.0, 1.0, 1),
    (20, 4, 0.5, 0.5, 0.5, 0.5, 2),
    (12, 2, 0.999, 1.0, 2.0, 1.0, 3),
    (7, 4, 0.9, 0.8, 1.5, 0.7, 4),
    (16, 1, 0.97, 0.95, 2.0, 2.0, 5),
    (128, 8, 0.99, 0.95, 1.0, 1.0, 6),
])
def test_vtrace_matches_repro(T, N, gamma, lam, rho_clip, c_clip, seed):
    x = inputs(T, N, seed)
    kw = dict(gamma=gamma, lam=lam, rho_clip=rho_clip, c_clip=c_clip)
    want = jax_vtrace(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    got = vtrace(**{k: torch.from_numpy(v) for k, v in x.items()}, **kw)
    assert isinstance(got, VTraceReturns)
    for name in ("vs", "pg_advantages"):
        g = getattr(got, name)
        assert g.shape == (T, N) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("T,N,gamma,lam,seed", [
    (1, 1, 0.99, 0.95, 0), (12, 3, 0.97, 0.5, 1), (20, 4, 0.5, 1.0, 2),
    (9, 2, 0.999, 0.8, 3),
])
def test_vtrace_reduces_to_gae_on_policy(T, N, gamma, lam, seed):
    """behavior == target and inactive clips: ``vs - values`` is GAE's
    advantage and ``vs`` its return (tests/test_rl.py's contract)."""
    x = {k: torch.from_numpy(v) for k, v in inputs(T, N, seed, False).items()}
    out = vtrace(**x, gamma=gamma, lam=lam, rho_clip=10.0, c_clip=10.0)
    adv, ret = gae(x["rewards"], x["values"], x["dones"],
                   x["bootstrap_value"], gamma, lam)
    np.testing.assert_allclose((out.vs - x["values"]).numpy(), adv.numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.vs.numpy(), ret.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_vtrace_on_policy_lam1_pg_adv_is_gae():
    x = {k: torch.from_numpy(v) for k, v in inputs(12, 3, 3, False).items()}
    out = vtrace(**x, gamma=0.97, lam=1.0, rho_clip=10.0, c_clip=10.0)
    adv, _ = gae(x["rewards"], x["values"], x["dones"],
                 x["bootstrap_value"], 0.97, 1.0)
    np.testing.assert_allclose(out.pg_advantages.numpy(), adv.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_ppo_config_has_the_vtrace_clips():
    j, t = jppo.PPOConfig(), tppo.PPOConfig()
    assert [f.name for f in j.__dataclass_fields__.values()] == [
        f.name for f in t.__dataclass_fields__.values()]
    assert (t.rho_clip, t.c_clip) == (j.rho_clip, j.c_clip) == (1.0, 1.0)


def hand_off(spec, T, M, act_dim, discrete, seed):
    """A pipelined collect's rollout: obs, actions, behavior logp,
    rewards, dones, ep_ret and last_obs."""
    rng = np.random.default_rng(seed)

    def obs(n):
        shape = (n,) + spec.obs_spec.shape
        if spec.obs_spec.dtype == torch.uint8:
            return rng.integers(0, 256, shape).astype(np.uint8)
        return rng.normal(0, 1, shape).astype(np.float32)

    if discrete:
        actions = rng.integers(0, act_dim, (T, M)).astype(np.int32)
    else:
        actions = rng.normal(0, 1, (T, M, act_dim)).astype(np.float32)
    return {"obs": obs(T * M).reshape((T, M) + spec.obs_spec.shape),
            "actions": actions,
            "logp": rng.normal(-2.0, 0.5, (T, M)).astype(np.float32),
            "rewards": rng.normal(0, 1, (T, M)).astype(np.float32),
            "dones": rng.random((T, M)) < 0.2,
            "ep_ret": rng.normal(0, 1, (T, M)).astype(np.float32),
            "last_obs": obs(M)}


@pytest.mark.parametrize("task", ["PongClassic-v5", "Ant-v3"])
def test_vtrace_ppo_update_matches_repro(task):
    jp = jax_registry.make(task, num_envs=4, obs=False)
    tp = repro_torch.make(task, num_envs=4, device="cpu")
    jn, tn = jnets.ActorCritic(jp.spec, (32, 32)), tnets.ActorCritic(
        tp.spec, (32, 32))
    cfg = dict(num_steps=4, epochs=2, minibatches=2, rho_clip=1.2,
               c_clip=0.9)
    jopt, jupd = jppo.make_vtrace_ppo_update(jn, jppo.PPOConfig(**cfg), 16)
    topt, tupd = tppo.make_vtrace_ppo_update(tn, tppo.PPOConfig(**cfg), 16)
    jparams = jn.init(jax.random.PRNGKey(0))
    tparams = tnets.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jstate = jppo.PPOState(jparams, jopt.init(jparams), jnp.int32(0))
    tstate = tppo.PPOState(tparams, topt.init(tparams),
                           torch.zeros((), dtype=torch.int32))
    roll = hand_off(tn.spec, 4, 6, tn.act_dim, tn.discrete, 1)
    jstate, jm = jax.jit(jupd)(jstate, jax.tree.map(jnp.asarray, roll),
                               jax.random.PRNGKey(2))
    tstate, tm = tupd(tstate, {k: torch.from_numpy(v)
                               for k, v in roll.items()}, R.PRNGKey(2))
    assert tm.keys() == jm.keys() and "rho_behavior" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert int(tstate.step) == int(jstate.step) == 4
    want = dict(tree_leaves_with_path(tnets.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), "cpu")))
    for path, leaf in tree_leaves_with_path(tstate.params):
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=0,
                                   atol=1e-5, err_msg=path)
