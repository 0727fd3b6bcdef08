"""The port's masked (event-driven tick) mode, ``make(...,
engine="device-masked")``, against ``repro``'s run live in the same
process: every busy lane advances one substep a tick until M results
are READY, served in completion order.

Streams are held as in tests/test_torch_pool.py (discrete fields
bitwise, Pong bitwise, Ant within 1e-4: XLA's fused multiply-adds and
``cos`` against torch's), and ``stats()`` bitwise.  Also:
``select_ready``'s tie order against ``lax.top_k``, the tick's physics
going through ``env_multi_step`` (whose plain version on the CPU equals
the per-lane substep bitwise), and a masked recv that could never fill
its block raising instead of spinning.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core.engine import DeviceEnvPool  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    READY,
    SchedState,
    get_scheduler,
)
from repro_torch.kernels.env_step import ops as env_ops  # noqa: E402

from _torch_pair import (  # noqa: E402
    assert_stats_equal,
    make_pair,
    rollout,
)


@pytest.mark.parametrize("task,n,m,schedule", [
    ("Ant-v3", 8, 4, "fifo"),
    ("PongClassic-v5", 4, 2, "sjf"),
    ("AntSkew-v3", 8, 4, "fifo"),
])
def test_masked_streams_match_repro(task, n, m, schedule):
    atol = 1e-4 if task.startswith("Ant") else 0.0
    jp, tp = make_pair(task, n, m, engine="device-masked",
                       schedule=schedule, max_episode_steps=5)
    assert tp.mode == "masked"
    costs = []
    jps, tps = rollout(jp, tp, 14, seed=2, atol=atol,
                       on_block=lambda t, j, x: costs.append(
                           x.step_cost.numpy()))
    assert_stats_equal(jp.stats(jps), tp.stats(tps), task)
    # the tick loop ran, at least one tick per substep of a served step
    assert tp.masked_ticks >= max(int(c.max()) for c in costs)
    if task == "AntSkew-v3":
        assert max(int(c.max()) for c in costs) > 9   # a heavy episode


def test_masked_tick_runs_the_physics_through_env_multi_step():
    """On the card the tick launches the env_step kernel at n_sub = 1;
    on the CPU the wrapper's plain version runs, which equals the
    per-lane substep of the env class bitwise."""
    pool = repro_torch.make("Ant-v3", 8, 4, engine="device-masked",
                            device="cpu")
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    calls = []
    real = env_ops.env_multi_step

    def spy(*args, **kw):
        calls.append(kw["n_sub"])
        return real(*args, **kw)

    import repro_torch.envs.mujoco_like as ml
    ml.env_multi_step = spy
    try:
        # the first step serves the four lanes still READY from reset;
        # the next ones tick
        for t in range(3):
            a = torch.rand((4, 8), generator=torch.Generator().manual_seed(t))
            ps, ts = pool.step(ps, a, ts.env_id)
    finally:
        ml.env_multi_step = real
    assert calls and set(calls) == {1}
    states = ps.env_states
    acts = torch.rand((8, 8), generator=torch.Generator().manual_seed(1))
    got = pool.benv.v_substep(states, acts)
    want = pool.env.substep(states, acts)
    for f in ("pos", "vel", "rot", "ang_vel", "q", "qd", "reward_acc"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_select_ready_keeps_lax_top_k_tie_order():
    rng = np.random.default_rng(11)
    n = 64
    ss = SchedState(
        phase=torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
        cost=torch.from_numpy(rng.integers(4, 7, n).astype(np.int32)),
        send_tick=torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)),
        tick=torch.tensor(6, dtype=torch.int32),
    )
    prio = np.where(ss.phase.numpy() == READY,
                    ss.send_tick.numpy().astype(np.float32), 1e9)
    for schedule in ("fifo", "sjf"):
        sched = get_scheduler(schedule)
        for m in (1, 9, 40):
            _, want = jax.lax.top_k(-jnp.asarray(prio, jnp.float32), m)
            np.testing.assert_array_equal(
                sched.select_ready(ss, m).numpy(), np.asarray(want))
        idx, overdue = sched.select_info(ss, 9)
        assert torch.equal(idx, sched.select(ss, 9))
        assert overdue.dtype == torch.int32 and overdue.shape == ()
        assert int(overdue) == 0


def test_masked_recv_that_cannot_fill_raises():
    pool = repro_torch.make("CartPole-v1", 4, 2, engine="device-masked",
                            device="cpu")
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    ps, ts = pool.recv(ps)          # the other two READY results
    with pytest.raises(RuntimeError, match="never be served"):
        pool.recv(ps)               # no READY left, no action sent


def test_make_device_masked_modes():
    pool = repro_torch.make("Ant-v3", 8, engine="device-masked",
                            device="cpu")
    assert pool.mode == "masked" and pool.batch_size == 8
    with pytest.raises(ValueError, match="unknown mode"):
        DeviceEnvPool(pool.env, 8, 4, mode="ticks", device="cpu")
