"""The port's three host engines against its device engine on the CPU,
and what sits around them: ``bind`` over a host pool with tensor actions
and ids, the async thread pool's per-env streams, ``make_py``'s numpy
envs against ``repro.make_py``'s, and ``list_engines``.

Every host engine steps each env as one lane of its batched env, the
device engine's per-lane computation, so on the CPU every field is
bitwise the device engine's (AntNorm's normalized obs within 1e-3: the
host block reaches the pipeline in another row order, and its sums run
in that order); the subprocess engine is also held bitwise to the
for-loop, which tests/test_torch_host_conformance.py holds to
``repro``'s.  ``stats()`` is bitwise across all of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import repro.core.registry as jax_registry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.protocol import bind  # noqa: E402

from _torch_host import (  # noqa: E402
    by_id,
    compare_blocks,
    device_rollout,
    host_rollout,
    reset_cost_as_device,
    to_np,
)
from _torch_pair import actions, assert_stats_equal  # noqa: E402

N, STEPS = 4, 8


def host(task, engine, n=N, m=None, **kw):
    return repro_torch.make(task, num_envs=n, batch_size=m, engine=engine,
                            num_threads=2, device="cpu", max_episode_steps=5,
                            **kw)


@pytest.mark.parametrize("engine", ["thread", "forloop", "subprocess"])
@pytest.mark.parametrize("task", ["Ant-v3", "PongClassic-v5", "AntNorm-v3",
                                  "CartPole-v1"])
def test_host_engine_matches_the_device_engine(task, engine):
    pool = host(task, engine)
    try:
        got = host_rollout(pool, pool.spec, STEPS)
        stats = pool.stats()
        assert pool.device == torch.device("cpu")
    finally:
        pool.close()
    dp = repro_torch.make(task, num_envs=N, device="cpu", max_episode_steps=5)
    want, want_stats = device_rollout(dp, STEPS)
    compare_blocks(f"{task} {engine}", reset_cost_as_device(got), want,
                   obs_atol=1e-3 if task == "AntNorm-v3" else 0.0)
    assert_stats_equal(want_stats, stats, f"{task} {engine}")
    if engine == "subprocess":
        fl = host(task, "forloop")
        compare_blocks(f"{task} subprocess vs forloop", got,
                       host_rollout(fl, fl.spec, STEPS))
        assert_stats_equal(fl.stats(), stats, task)


@pytest.mark.parametrize("engine", ["thread", "forloop"])
def test_bind_over_a_host_pool_takes_tensor_actions(engine):
    """``bind``'s host branch hands actions and ids to the pool as they
    come, tensors included; the stream is the one numpy actions give."""
    want = host_rollout(host("Ant-v3", engine), repro_torch.make(
        "Ant-v3", 4, device="cpu").spec, 4)
    h = bind(host("Ant-v3", engine))
    try:
        ts = h.reset()
        assert not h.functional and h.state is None
        got = [by_id(ts)]
        for t in range(4):
            a = torch.from_numpy(actions(h.spec, to_np(ts.env_id), t))
            if t % 2:
                ts = h.step(a, ts.env_id)
            else:
                h.send(a, ts.env_id)
                ts = h.recv()
            assert isinstance(ts.obs, torch.Tensor)
            got.append(by_id(ts))
        assert h.stats()["recvs"] == 5
    finally:
        h.close()
    compare_blocks(f"bind {engine}", got, want)


def test_async_thread_pool_keeps_each_env_stream():
    """An async thread pool (N = 8, M = 4) serves whichever envs finish
    first, but each env's own stream is the one it has when stepped on
    its own: env ``i``'s ``k``-th step, with action ``table[k][i]``,
    equals the sync for-loop's.  An env's first serve is its reset;
    four resets wait a recv, so 16 recvs serve 60 steps."""
    rng = np.random.default_rng(7)
    table = rng.uniform(-1, 1, (40, 8, 8)).astype(np.float32)
    pool = host("Ant-v3", "thread", n=8, m=4)
    serves = {i: [] for i in range(8)}
    count = np.zeros(8, int)
    try:
        pool.async_reset()
        for t in range(17):
            out = pool.recv() if t == 0 else pool.step(
                table[count[ids], ids], ids)
            if t:
                count[ids] += 1
            blk = by_id(out)
            for j, i in enumerate(blk["env_id"]):
                serves[int(i)].append({k: v[j] for k, v in blk.items()})
            ids = blk["env_id"]
            assert len(set(ids.tolist())) == 4
        stats = pool.stats()
    finally:
        pool.close()
    steps = {i: s[1:] for i, s in serves.items()}
    assert stats["served"] == 17 * 4 == int(stats["serves"].sum())
    assert stats["stepped"] == 16 * 4 - 4 == sum(map(len, steps.values()))
    fl = host("Ant-v3", "forloop", n=8)
    fl.reset()
    for k in range(max(map(len, steps.values()))):
        want = by_id(fl.step(table[k], np.arange(8)))
        for i in range(8):
            if k < len(steps[i]):
                for f in ("reward", "done", "obs", "step_cost"):
                    np.testing.assert_array_equal(
                        steps[i][k][f], want[f][i], err_msg=f"env {i} {k}")


@pytest.mark.parametrize("task,act", [
    ("CartPole-v1", lambda r: int(r.integers(0, 2))),
    ("Pendulum-v1", lambda r: r.uniform(-2, 2, 1).astype(np.float32)),
    ("Pong-v5", lambda r: int(r.integers(0, 6))),
    ("Ant-v3", lambda r: r.uniform(-1, 1, 8).astype(np.float32)),
])
def test_make_py_streams_match_repro(task, act):
    """The same numpy, so the same stream: obs, reward, done and every
    info field bitwise over 300 steps (episodes end and reset)."""
    tenv = repro_torch.make_py(task, seed=3, max_episode_steps=40)
    jenv = jax_registry.make_py(task, seed=3, max_episode_steps=40)
    assert tenv.spec.obs_spec.shape == jenv.spec.obs_spec.shape
    assert tenv.spec.act_spec.dtype == getattr(
        torch, np.dtype(jenv.spec.act_spec.dtype).name)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    dones = 0
    for t in range(300):
        got, want = tenv.step(act(r1)), jenv.step(act(r2))
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"obs {t}")
        assert got[1:] == want[1:], t
        dones += got[2]
    assert dones > 0


def test_make_py_and_list_engines():
    assert repro_torch.list_engines() == jax_registry.list_engines()
    with pytest.raises(KeyError, match="no python env"):
        repro_torch.make_py("TokenCopy-v0")

    class Custom(repro_torch.make_py("CartPole-v1").__class__):
        pass

    repro_torch.register_py("Custom-v0", Custom)
    assert isinstance(repro_torch.make_py("Custom-v0", seed=1), Custom)


@pytest.mark.parametrize("engine", ["thread", "forloop"])
def test_host_engine_over_a_numpy_env(engine):
    """The host pools step any ``HostEnv``: the Py envs of ``make_py``
    too, as the paper's Table 2 Python rows."""
    from repro_torch.core.baselines import ForLoopEnv
    from repro_torch.core.host_pool import ThreadEnvPool

    fns = [lambda i=i: repro_torch.make_py("Pong-v5", seed=i)
           for i in range(4)]
    pool = (ThreadEnvPool(fns, num_threads=2) if engine == "thread"
            else ForLoopEnv(fns))
    try:
        out = pool.reset()
        for _ in range(3):
            out = pool.step(np.zeros(4, np.int32), out["env_id"])
        assert tuple(out["obs"].shape) == (4, 84, 84)
        assert out["obs"].dtype == torch.uint8
        assert bool((out["step_cost"] >= 4).all())
    finally:
        pool.close()
