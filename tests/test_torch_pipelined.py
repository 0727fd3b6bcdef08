"""The port's pipelined drivers (``repro_torch.rl.ppo.train_pipelined``,
``train_host_pipelined``) and ``StateBufferQueue.put_batch`` against the
JAX package's, run live.

``train_pipelined`` is deterministic in both packages (its two halves
share no output), so whole runs are compared: 2 iterations of 2 epochs
of 2 minibatches at ``test_train_device_matches_repro``'s tolerances
(the same episodes, losses and metrics within 1e-4 relative, params
within 1e-5).  ``train_host_pipelined`` is deterministic only in its
first iteration, whose blocks are all sampled behind the initial params;
so one iteration is compared, on engines whose block order is fixed
(forloop, and thread with one worker), at ``train_host``'s tolerances
(the actions the actor sends within 1e-4 for Ant, bitwise for CartPole;
losses within 1e-5 relative; params within 1e-4 for Ant, whose rollout
carries 1e-4, and 1e-5 for CartPole, the V-trace update's tolerance,
tests/test_torch_vtrace.py).  Longer runs are smoke tests.
"""

import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.rl.ppo as jppo  # noqa: E402
import _torch_raising_env  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.baselines import ForLoopEnv  # noqa: E402
from repro_torch.core.buffers import StateBufferQueue  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.rl import ppo as tppo  # noqa: E402
from repro_torch.rl.nets import params_from_jax  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402

HIDDEN = (32, 32)
# tests/test_rl.py's pipelined configuration
TOKEN_KW = dict(ep_len=8, vocab=8, ctx_len=16)


def assert_params_close(tparams, jparams, atol):
    want = dict(tree_leaves_with_path(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")))
    got = dict(tree_leaves_with_path(tparams))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=0,
                                   atol=atol, err_msg=path)


def assert_history_close(th, jh, rtol):
    assert len(th) == len(jh)
    for jr, tr in zip(jh, th):
        assert tr.keys() == jr.keys() and "rho_behavior" in tr
        for k in ("iter", "env_steps", "episodes"):
            assert tr[k] == jr[k], k
        for k in ("loss", "vf", "ent", "ratio", "rho_behavior",
                  "mean_return"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"iter {tr['iter']} {k}")
        np.testing.assert_allclose(tr["pg"], jr["pg"], rtol=0, atol=1e-5,
                                   err_msg=f"iter {tr['iter']} pg")


@pytest.mark.parametrize("task,n,kw", [
    ("Ant-v3", 8, dict(max_episode_steps=5)),
    ("PongClassic-v5", 4, dict(max_episode_steps=5)),
    ("TokenCopy-v0", 8, TOKEN_KW),
])
def test_train_pipelined_matches_repro(task, n, kw):
    jp = jax_registry.make(task, num_envs=n, obs=False, **kw)
    tp = repro_torch.make(task, num_envs=n, device="cpu", **kw)
    cfg = dict(total_steps=2 * 8 * n, num_steps=8, minibatches=2, epochs=2,
               lr=3e-4)
    js, _, jh = jppo.train_pipelined(jp, jppo.PPOConfig(**cfg), seed=3,
                                     hidden=HIDDEN)
    logged = []
    ts, _, th = tppo.train_pipelined(tp, tppo.PPOConfig(**cfg), seed=3,
                                     hidden=HIDDEN, log_fn=logged.append)
    assert logged == th and len(th) == 2
    assert_history_close(th, jh, rtol=1e-4)
    assert all(np.isfinite(r["rho_behavior"]) for r in th)
    assert int(ts.step) == int(js.step) == 2 * 2 * 2
    assert_params_close(ts.params, js.params, atol=1e-5)


def test_train_pipelined_refuses_a_host_pool():
    host = repro_torch.make("CartPole-v1", num_envs=4, engine="forloop",
                            device="cpu")
    with pytest.raises(ValueError, match="train_host_pipelined"):
        tppo.train_pipelined(host, tppo.PPOConfig())


def record_actions(pool, log):
    """Wrap ``pool.step`` to keep the actions it is sent, as numpy."""
    step = pool.step

    def logged(actions, env_ids):
        log.append(np.array(actions))
        return step(actions, env_ids)

    pool.step = logged


@pytest.mark.parametrize("task,n,engine,atol", [
    ("Ant-v3", 8, "forloop", 1e-4), ("CartPole-v1", 8, "thread", 0.0),
])
def test_train_host_pipelined_first_iteration_matches_repro(task, n, engine,
                                                            atol):
    kw = dict(num_envs=n, engine=engine, num_threads=1, max_episode_steps=5)
    jp = jax_registry.make(task, obs=False, **kw)
    tp = repro_torch.make(task, device="cpu", **kw)
    jacts, tacts = [], []
    record_actions(jp, jacts)
    record_actions(tp, tacts)
    cfg = dict(total_steps=8 * n, num_steps=8, epochs=1, minibatches=2)
    try:
        js, _, jh, jprof = jppo.train_host_pipelined(
            jp, cfg=jppo.PPOConfig(**cfg), seed=3, hidden=HIDDEN)
        ts, _, th, tprof = tppo.train_host_pipelined(
            tp, cfg=tppo.PPOConfig(**cfg), seed=3, hidden=HIDDEN,
            device="cpu")
    finally:
        jp.close()
        tp.close()
    # the actor runs on past the iteration; its first 8 steps fed it
    assert len(tacts) >= 8 and len(jacts) >= 8
    for t, (got, want) in enumerate(zip(tacts[:8], jacts[:8])):
        assert got.dtype == want.dtype, t
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"actions {t}")
    assert set(tprof) == set(jprof) == {"actor_wait", "train", "other"}
    assert_history_close(th, jh, rtol=1e-5)
    assert int(ts.step) == int(js.step) == 2
    assert_params_close(ts.params, js.params, atol=atol or 1e-5)


def test_train_host_pipelined_smoke():
    """Three iterations on the thread engine (two workers): no deadlock
    against the bounded ring, finite metrics, the three buckets as
    spans of a passed tracer."""
    pool = repro_torch.make("TokenCopy-v0", num_envs=8, engine="thread",
                            num_threads=2, device="cpu", **TOKEN_KW)
    tr = Tracer()
    try:
        cfg = tppo.PPOConfig(total_steps=8 * 8 * 3, num_steps=8,
                             minibatches=2, epochs=2, lr=3e-4)
        state, _, hist, prof = tppo.train_host_pipelined(
            pool, cfg=cfg, seed=0, hidden=HIDDEN, tracer=tr, device="cpu")
    finally:
        pool.close()
    assert len(hist) == 3 and int(state.step) == 12
    for k in ("loss", "mean_return", "rho_behavior"):
        assert all(np.isfinite(h[k]) for h in hist), k
    assert set(prof) == {"actor_wait", "train", "other"}
    assert prof == {k: tr.totals()[k] for k in prof}
    names = [e["name"] for e in tr.events()]
    assert names.count("train") == names.count("actor_wait") == 3


def test_train_host_pipelined_surfaces_an_actor_failure():
    """An env that raises in the actor thread surfaces from the learner
    as ``RuntimeError`` chained to the env's error, within one take
    timeout, and the actor thread is gone afterwards."""
    fns = [functools.partial(_torch_raising_env.RaisingFactory(), i)
           for i in range(2)]
    pool = ForLoopEnv(fns, device="cpu")
    before = set(threading.enumerate())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="pipelined actor thread died"
                       ) as info:
        tppo.train_host_pipelined(
            pool, cfg=tppo.PPOConfig(total_steps=16, num_steps=8),
            hidden=(8,), device="cpu")
    assert time.monotonic() - t0 < 15.0
    assert isinstance(info.value.__cause__, ValueError)
    assert "boom in worker" in str(info.value.__cause__)
    assert not set(threading.enumerate()) - before   # the actor is gone


def test_state_queue_put_batch_straddles_blocks():
    """One put_batch spanning a block boundary slice-writes each block
    it spans and keeps allocation order."""
    q = StateBufferQueue({"x": ((), np.int32)}, 4, 8)     # 3 blocks of 4
    q.put_batch({"x": np.arange(6)})                      # blk0, half blk1
    assert q.take(timeout=1)["x"].tolist() == [0, 1, 2, 3]
    q.put_batch({"x": np.arange(6, 8)})                   # completes blk1
    assert q.take(timeout=1)["x"].tolist() == [4, 5, 6, 7]
    q.put_batch({"x": np.arange(0)})                      # empty: no-op
    q.put_batch({"x": np.arange(8, 14)})                  # wraps the ring
    assert q.take(timeout=1)["x"].tolist() == [8, 9, 10, 11]


def test_state_queue_put_batch_backpressure():
    """A producer blocks once num_blocks * batch slots are outstanding,
    and a timed-out put leaves the queue as it was."""
    q = StateBufferQueue({"x": ((), np.int32)}, 4, 4)     # 2 blocks = 8
    q.put_batch({"x": np.arange(8)})
    with pytest.raises(TimeoutError):
        q.put_batch({"x": np.arange(8, 12)}, timeout=0.05)
    assert q.take(timeout=1)["x"].tolist() == [0, 1, 2, 3]
    q.put_batch({"x": np.arange(8, 12)}, timeout=1)
    assert q.take(timeout=1)["x"].tolist() == [4, 5, 6, 7]
    assert q.take(timeout=1)["x"].tolist() == [8, 9, 10, 11]


def test_state_queue_put_batch_against_a_taker_thread():
    """A producer thread streaming put_batch in runs of 3 against a
    taking loop over a 2-block ring: every row once, in order."""
    q = StateBufferQueue({"x": ((), np.int64)}, 4, 4)
    rows = np.arange(15 * 4)

    def writer():
        for lo in range(0, rows.size, 3):
            q.put_batch({"x": rows[lo:lo + 3]}, timeout=5)

    t = threading.Thread(target=writer)
    t.start()
    got = [q.take(timeout=5)["x"] for _ in range(15)]
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), rows)
