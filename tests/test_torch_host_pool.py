"""The port's host engines (``repro_torch.core.host_pool``,
``core.baselines``): the counterparts of tests/test_host_pool.py on the
port's own CartPole and TokenSkew, the queues of ``core.buffers``, and
the kernel plumbing the worker threads lean on: one library build
however many threads reach it first, and launch counts that lose
nothing under threads.

Streams against ``repro`` and the device engine are in
tests/test_torch_host_conformance.py and tests/test_torch_host_engines.py.
"""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import repro_torch  # noqa: E402
from repro_torch.core.buffers import (  # noqa: E402
    ActionBufferQueue,
    StateBufferQueue,
)
from repro_torch.core.host_pool import HostEnv, ThreadEnvPool  # noqa: E402
from repro_torch.envs.classic import CartPole  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make(task, n, m=None, engine="thread", **kw):
    return repro_torch.make(task, num_envs=n, batch_size=m, engine=engine,
                            device="cpu", **kw)


def test_thread_pool_serves_all_envs():
    pool = make("CartPole-v1", 8, 4, num_threads=2)
    try:
        pool.async_reset()
        out = pool.recv()
        seen = set(out["env_id"].tolist())
        for _ in range(20):
            out = pool.step(torch.zeros(4, dtype=torch.int32),
                            out["env_id"])
            seen.update(out["env_id"].tolist())
        assert seen == set(range(8))
    finally:
        pool.close()


def test_thread_pool_batch_exactly_m():
    pool = make("CartPole-v1", 6, 3, num_threads=2)
    try:
        pool.async_reset()
        out = pool.recv()
        assert tuple(out["obs"].shape) == (3, 4)
        assert len(set(out["env_id"].tolist())) == 3
        for k, v in out.items():
            assert isinstance(v, torch.Tensor) and v.shape[0] == 3, k
    finally:
        pool.close()


def test_thread_pool_no_result_loss():
    """Every send produces exactly one recv slot (conservation)."""
    pool = make("CartPole-v1", 4, 2, num_threads=2)
    try:
        pool.async_reset()          # enqueues 4 results (2 blocks of 2)
        out = pool.recv()           # drains block 1
        recvs = len(out["env_id"])
        for _ in range(10):         # each loop: send 2, recv one block of 2
            pool.send(np.zeros(2, dtype=np.int64), out["env_id"])
            out = pool.recv()
            recvs += len(out["env_id"])
        assert recvs == 2 + 10 * 2
        stats = pool.stats()
        assert stats["served"] == stats["recvs"] * 2 == recvs
    finally:
        pool.close()


class Bomb(HostEnv):
    spec = CartPole().spec

    def reset(self):
        return np.zeros(self.spec.obs_spec.shape, np.float32)

    def step(self, action):
        raise ValueError("thread boom")


def test_thread_worker_exception_propagates_fast():
    """A worker exception surfaces on the next recv with its traceback,
    not after the 60 s block timeout; later recvs re-raise; close()
    still works."""
    pool = ThreadEnvPool([Bomb, Bomb], batch_size=2, num_threads=1)
    try:
        out = pool.reset()
        pool.send(np.zeros(2, np.int64), out["env_id"])
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="thread boom"):
            pool.recv()
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(RuntimeError, match="thread boom"):
            pool.recv()
    finally:
        pool.close()


def test_thread_sjf_schedule_orders_queue_by_cost():
    """The numpy scheduler mirror: with schedule='sjf' and one worker,
    work executes (and the block fills) in last-observed-cost order."""
    pool = make("TokenSkew-v0", 4, num_threads=1, schedule="sjf")
    try:
        out = pool.reset()
        out = pool.step(np.zeros(4, np.int32), out["env_id"])
        cost_by_env = np.ones(4)
        cost_by_env[out["env_id"].numpy()] = np.maximum(
            out["step_cost"].numpy(), 1)
        assert len(set(cost_by_env.tolist())) > 1
        ids = out["env_id"].numpy()
        out = pool.step(np.zeros(4, np.int32), ids)
        expected = ids[np.argsort(cost_by_env[ids], kind="stable")]
        np.testing.assert_array_equal(out["env_id"].numpy(), expected)
    finally:
        pool.close()


@pytest.mark.parametrize("kwargs,error", [
    ({"schedule": "hierarchical"}, "cross-shard policy"),
    ({"schedule": "random"}, "unknown schedule"),
    ({"cost_ema_alpha": 0.0}, "cost_ema_alpha"),
    ({"batch_size": 8}, "cannot exceed"),
    ({"engine": "forloop", "schedule": "sjf"}, "synchronous"),
    ({"engine": "subprocess", "schedule": "sjf"}, "synchronous"),
])
def test_host_engines_refuse_bad_options(kwargs, error):
    kw = {"engine": "thread", **kwargs}
    with pytest.raises(ValueError, match=error):
        repro_torch.make("CartPole-v1", num_envs=4, device="cpu", **kw)


def test_subprocess_worker_exception_propagates_and_close_idempotent():
    """A spawned worker's env exception ships its traceback back (the
    pipe does not hang), the error state is terminal, and close() is
    idempotent."""
    import _torch_raising_env

    from repro_torch.core.baselines import SubprocessEnv

    pool = SubprocessEnv(_torch_raising_env.RaisingFactory(), num_envs=2,
                         num_workers=1)
    try:
        out = pool.reset()
        assert tuple(out["obs"].shape) == (2, 4)
        with pytest.raises(RuntimeError, match="boom in worker"):
            pool.step(np.zeros(2, np.int64))
        with pytest.raises(RuntimeError, match="boom in worker"):
            pool.reset()  # terminal error state
    finally:
        pool.close()
        pool.close()  # idempotent


def test_close_under_backpressure_does_not_hang():
    """close() on a pool whose consumer vanished mid-flight: results
    saturate the StateBufferQueue, workers wedge in acquire_slot, and
    close() still returns promptly."""
    pool = make("CartPole-v1", 8, 4, num_threads=2)
    pool.async_reset()          # 8 results; never recv'd -> buffer fills
    time.sleep(0.5)             # let workers wedge under backpressure
    t0 = time.monotonic()
    pool.close()
    assert time.monotonic() - t0 < 8.0
    for t in pool._threads:
        t.join(timeout=5.0)
        assert not t.is_alive()


@pytest.mark.parametrize("engine", ["thread", "subprocess"])
def test_dropped_pool_does_not_block_exit(engine):
    """A pool that is never close()d, whose results are never recv'd,
    must not keep the interpreter alive."""
    m, start = ((4, "pool.async_reset()") if engine == "thread"
                else (None, "pool.reset()"))
    code = (
        "import repro_torch, time\n"
        f"pool = repro_torch.make('CartPole-v1', engine={engine!r},\n"
        f"                         num_envs=8, batch_size={m},\n"
        "                         num_threads=2, device='cpu')\n"
        f"{start}\n"             # the thread pool's results are never recv'd
        "time.sleep(0.5)\n"
        "print('DROPPED')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DROPPED" in proc.stdout


def test_episode_stats_flow_through_info():
    """EnvPool contract: episode_return and episode_length at done."""
    pool = make("CartPole-v1", 2, num_threads=1)
    try:
        out = pool.reset()
        for _ in range(600):
            out = pool.step(np.zeros(2, dtype=np.int64), out["env_id"])
            if bool(out["done"].any()):
                idx = out["done"]
                assert bool((out["episode_length"][idx] > 0).all())
                assert bool((out["episode_return"][idx] > 0).all())
                break
        else:
            pytest.fail("no episode ended in 600 steps")
    finally:
        pool.close()


def test_reset_refuses_a_partial_block():
    pool = make("CartPole-v1", 4, 2, num_threads=1)
    try:
        with pytest.raises(RuntimeError, match="async_reset"):
            pool.reset()
    finally:
        pool.close()


def test_forloop_and_sync_facade():
    """The sync engines' send/recv facade: one outstanding send, a
    parked reset, every env's reward in order."""
    fl = make("CartPole-v1", 4, engine="forloop")
    fl.async_reset()
    with pytest.raises(RuntimeError, match="twice"):
        fl.send(np.ones(4, np.int64))
    out = fl.recv()
    assert out["env_id"].tolist() == [0, 1, 2, 3]
    fl.send(np.ones(4, np.int64))
    with pytest.raises(RuntimeError, match="outstanding"):
        fl.async_reset()
    out = fl.recv()
    assert tuple(out["obs"].shape) == (4, 4)
    assert out["reward"].tolist() == [1.0] * 4
    with pytest.raises(RuntimeError, match="pending"):
        fl.recv()


# ---------------------------------------------------------------------- #
# the queues (paper Appendix D)
# ---------------------------------------------------------------------- #
def test_action_queue_fifo_and_backpressure():
    q = ActionBufferQueue(2)                 # capacity 4
    q.put_batch([1, 2, 3])
    assert [q.get(timeout=1) for _ in range(3)] == [1, 2, 3]
    q.put_batch([4, 5, 6, 7])
    with pytest.raises(TimeoutError):
        q.put_batch([8], timeout=0.05)       # full: backpressure
    with pytest.raises(ValueError, match="capacity"):
        q.put_batch(list(range(5)))
    q.put_batch([])                          # no-op
    assert q.get(timeout=1) == 4
    with pytest.raises(TimeoutError):
        ActionBufferQueue(1).get(timeout=0.01)


def test_state_queue_blocks_fill_in_slot_order_and_transfer():
    fields = {"x": ((2,), np.float32), "i": ((), np.int32)}
    q = StateBufferQueue(fields, batch_size=2, num_envs=4)
    assert q.num_blocks == 3
    for k in range(4):
        blk, slot = q.acquire_slot(timeout=1)
        blk.write(slot, {"x": [k, k], "i": k})
    a = q.take(timeout=1)
    b = q.take(timeout=1)
    assert a["i"].tolist() == [0, 1] and b["i"].tolist() == [2, 3]
    blk, slot = q.acquire_slot(timeout=1)
    blk.write(slot, {"x": [9, 9], "i": 9})
    assert a["i"].tolist() == [0, 1]         # ownership moved: no reuse
    with pytest.raises(TimeoutError):
        q.take(timeout=0.05)                 # block 2 not full yet
    for _ in range(5):                       # 6 slots in the ring
        q.acquire_slot(timeout=1)
    with pytest.raises(TimeoutError):
        q.acquire_slot(timeout=0.05)         # backpressure


# ---------------------------------------------------------------------- #
# kernel plumbing under threads
# ---------------------------------------------------------------------- #
def test_library_builds_once_when_eight_threads_first_touch_it(
        monkeypatch, tmp_path):
    """Eight threads that reach their first kernel together get one build
    (a stub ``_compile`` that takes its time) and the same library."""
    from repro_torch.kernels import build

    builds = []

    def fake_compile(nvcc, sources, out):
        builds.append(out)
        time.sleep(0.2)
        out.write_bytes(b"")

    class FakeLib:
        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_compile", fake_compile)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    build._load.cache_clear()
    try:
        barrier = threading.Barrier(8)
        libs = []

        def first_touch():
            barrier.wait()
            libs.append(build.library())

        threads = [threading.Thread(target=first_touch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(builds) == 1
        assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    finally:
        build._load.cache_clear()


def test_launch_counts_are_exact_under_eight_threads():
    """``count_launch`` loses no count when eight threads count at once,
    even on a counter whose read lets go of the GIL before the write (a
    bare ``+=`` reads, adds and writes back, and would lose counts
    there); ``fn.launches`` stays the public reading."""
    from repro_torch.kernels.backend import count_launch

    class YieldingCounter:
        def __init__(self):
            self._n = 0

        @property
        def launches(self):
            n = self._n
            time.sleep(0)       # another thread may run here
            return n

        @launches.setter
        def launches(self, n):
            self._n = n

    op = YieldingCounter()
    barrier = threading.Barrier(8)

    def launch():
        barrier.wait()
        for _ in range(500):
            count_launch(op)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert op.launches == 8 * 500


def test_reset_launches_zeroes_every_kernel_count():
    """``reset_launches`` zeroes each wrapper's count under the counters'
    lock, and ``launch_counts`` reads every kernel of ``kernel_ops``."""
    from repro_torch.kernels.backend import (
        count_launch,
        kernel_ops,
        launch_counts,
        reset_launches,
    )

    ops = kernel_ops()
    saved = {k: op.launches for k, op in ops.items()}
    try:
        count_launch(ops["env_step"])
        assert launch_counts()["env_step"] == saved["env_step"] + 1
        reset_launches(ops.values())
        assert launch_counts() == {k: 0 for k in ops}
    finally:
        for k, op in ops.items():
            op.launches = saved[k]


def test_subprocess_pool_reads_its_workers_launch_counts():
    """A subprocess pool's envs step in its workers, so their kernels
    count there: ``launches()`` sums every worker's counts (none on the
    CPU, where the plain versions run)."""
    from repro_torch.kernels.backend import kernel_ops

    pool = make("Ant-v3", 4, engine="subprocess", num_threads=2)
    try:
        out = pool.reset()
        pool.step(np.zeros((4, 8), np.float32), out["env_id"])
        assert pool.launches() == {k: 0 for k in kernel_ops()}
    finally:
        pool.close()
