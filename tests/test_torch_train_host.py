"""The port's host-engine loops against the JAX package's, run live:
the host branch of ``collect_init``/``build_collect_fn``
(``repro.core.xla_loop.collect_host``) and ``train_host``.

The thread pools run one worker, so each block comes back in the order
it was sent in both packages (with more workers a sync block is in
finishing order, and the policy's draws follow the rows).  Tolerances:
discrete actions, ids and done bitwise; Ant's obs, reward and actions
within 1e-4 (tests/test_torch_collect.py says why); ``train_host`` at
``test_torch_ppo.py``'s four-update size (two iterations of one epoch
of two minibatches, the size ``scripts/train_sensitivity.py`` shows to
stay at rounding): the same episodes, losses within 1e-5 relative,
params within 1e-4 (Ant, its rollout carrying 1e-4) and 1e-6
(CartPole).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.core.xla_loop as jloop  # noqa: E402
import repro.rl.ppo as jppo  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import xla_loop as tloop  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.rl import ppo as tppo  # noqa: E402
from repro_torch.rl.nets import params_from_jax  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402

HIDDEN = (32, 32)


def pools(task, n, engine):
    kw = dict(num_envs=n, engine=engine, num_threads=1, max_episode_steps=5)
    return (jax_registry.make(task, obs=False, **kw),
            repro_torch.make(task, device="cpu", **kw))


def jax_policy(params, obs, key):
    m = obs.shape[0]
    if obs.ndim == 2:
        return (jax.random.uniform(key, (m, 8), jnp.float32, -1.0, 1.0)
                * 0.5 + 0.5 * jnp.clip(obs[:, :8], -1.0, 1.0))
    pixel = obs[:, -1, 40, params].astype(jnp.int32)
    return (jax.random.randint(key, (m,), 0, 6) + pixel) % 6


def torch_policy(params, obs, key):
    m = obs.shape[0]
    if obs.ndim == 2:
        return (R.uniform(key, (m, 8), -1.0, 1.0) * 0.5
                + 0.5 * torch.clamp(obs[:, :8], -1.0, 1.0))
    pixel = obs[:, -1, 40, params].to(torch.int32)
    return (R.randint(key, (m,), 0, 6) + pixel) % 6


@pytest.mark.parametrize("task,n,engine", [
    ("Ant-v3", 4, "forloop"), ("PongClassic-v5", 4, "thread"),
])
def test_host_collect_matches_repro(task, n, engine):
    atol = 1e-4 if task.startswith("Ant") else 0.0
    jp, tp = pools(task, n, engine)
    try:
        jps, jts = jloop.collect_init(jp, jax.random.PRNGKey(0))
        tps, tts = tloop.collect_init(tp, R.PRNGKey(0))
        assert jps is None and tps is None
        jcol = jloop.build_collect_fn(jp, jax_policy, 6)
        tcol = tloop.build_collect_fn(tp, torch_policy, 6)
        for k in (5, 6):
            _, jts, jtraj, jacts = jcol(None, 50, jts, jax.random.PRNGKey(k))
            _, tts, ttraj, tacts = tcol(None, 50, tts, R.PRNGKey(k))
            assert tuple(ttraj.obs.shape) == jtraj.obs.shape
            for f in ("env_id", "done", "terminated", "truncated",
                      "step_cost", "episode_length"):
                np.testing.assert_array_equal(
                    getattr(ttraj, f).numpy(), np.asarray(getattr(jtraj, f)),
                    err_msg=f"{task} {f}")
            for f, got, want in (
                    ("obs", ttraj.obs, jtraj.obs),
                    ("reward", ttraj.reward, jtraj.reward),
                    ("actions", tacts, jacts)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=atol,
                                           err_msg=f"{task} {f}")
        assert bool(np.asarray(jtraj.done).any())
    finally:
        jp.close()
        tp.close()


def record_actions(pool, log):
    """Wrap ``pool.step`` to keep the actions it is sent, as numpy."""
    step = pool.step

    def logged(actions, env_ids):
        log.append(np.array(actions))
        return step(actions, env_ids)

    pool.step = logged


@pytest.mark.parametrize("task,n,atol", [
    ("Ant-v3", 8, 1e-4), ("CartPole-v1", 8, 0.0),
])
def test_train_host_matches_repro(task, n, atol):
    jp, tp = pools(task, n, "thread")
    jacts, tacts = [], []
    record_actions(jp, jacts)
    record_actions(tp, tacts)
    cfg = dict(total_steps=2 * 8 * n, num_steps=8, epochs=1, minibatches=2)
    try:
        js, _, jh, jprof = jppo.train_host(jp, cfg=jppo.PPOConfig(**cfg),
                                           seed=3, hidden=HIDDEN)
        ts, tnet, th, tprof = tppo.train_host(
            tp, cfg=tppo.PPOConfig(**cfg), seed=3, hidden=HIDDEN,
            device="cpu")
    finally:
        jp.close()
        tp.close()
    assert len(tacts) == len(jacts) == 16
    for t, (got, want) in enumerate(zip(tacts, jacts)):
        assert got.dtype == want.dtype, t
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"actions {t}")
    assert set(tprof) == set(jprof) == {"env_step", "inference", "train",
                                        "other"}
    assert len(th) == len(jh) == 2
    for jr, tr in zip(jh, th):
        assert tr.keys() == jr.keys()
        for k in ("iter", "env_steps", "episodes"):
            assert tr[k] == jr[k], k
        for k in ("loss", "vf", "ent", "ratio"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"iter {tr['iter']} {k}")
    assert int(ts.step) == int(js.step) == 4
    want = dict(tree_leaves_with_path(params_from_jax(
        jax.tree.map(np.asarray, js.params), "cpu")))
    for path, leaf in tree_leaves_with_path(ts.params):
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=0,
                                   atol=atol or 1e-6, err_msg=path)


def test_train_host_profile_spans_and_metrics():
    """The four Fig. 4 buckets are ``obs/trace.py`` spans: a passed
    ``tracer`` holds them (one inference and env_step span a step), the
    profile is its totals, and a ``registry`` gets ``ppo_*`` metrics."""
    pool = repro_torch.make("CartPole-v1", 4, batch_size=2, engine="thread",
                            num_threads=1, device="cpu")
    tr, reg = Tracer(), MetricsRegistry()
    logged = []
    try:
        state, _, history, prof = tppo.train_host(
            pool, cfg=tppo.PPOConfig(total_steps=2 * 4 * 2, num_steps=4,
                                     epochs=1, minibatches=2),
            hidden=(8,), tracer=tr, registry=reg, device="cpu",
            log_fn=logged.append)
    finally:
        pool.close()
    names = [e["name"] for e in tr.events()]
    assert names.count("inference") == names.count("env_step") == 8
    assert names.count("train") == 2
    assert prof == {k: tr.totals()[k] for k in prof}
    assert all(v > 0 for v in prof.values())
    assert logged == history and history[-1]["env_steps"] == 16
    assert int(state.step) == 4
    assert any(k.startswith("ppo_") for k in reg.snapshot())
