"""The port's engine counters (``repro_torch/obs/telemetry.py``) and
``pool.stats()`` against ``repro``'s, run live in the same process.

Counters are integer adds, so everything here is bitwise: the update
functions on seeded random blocks, and ``stats()`` after the same
rollout of both packages on sync, async (fifo, sjf) and masked pools.
Also the conservation laws (``served = recvs * M``, ``sum(serves) =
served``, ``sum(wait_hist) = served``, ``stepped <= served``), served
streams that do not move with ``obs``, and ``publish_pool_stats``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.obs.metrics as jax_metrics  # noqa: E402
import repro.obs.telemetry as jt  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402
from repro_torch.obs import telemetry as tt  # noqa: E402

from _torch_pair import (  # noqa: E402
    assert_stats_equal,
    compare,
    make_pair,
    rollout,
)


def as_np(tele) -> dict:
    return {f: np.asarray(getattr(tele, f)) for f in (
        "serves", "wait_ticks", "wait_hist", "served", "stepped",
        "cost_sum", "overdue_admits")}


def assert_tele_equal(jtele, ttele, tag=""):
    want, got = as_np(jtele), as_np(ttele)
    for k in want:
        assert got[k].dtype == np.int32, (tag, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag} {k}")


def block(rng, n, m):
    """One recv block's inputs: distinct lanes, waits across every bucket
    (negative and beyond the last edge too), a stepped mask, costs."""
    idx = rng.permutation(n)[:m].astype(np.int32)
    wait = rng.integers(-2, 100, m).astype(np.int32)
    stepped = rng.random(m) < 0.6
    cost = rng.integers(1, 22, m).astype(np.int32)
    overdue = np.int32(rng.integers(0, 3))
    return idx, wait, stepped, cost, overdue


@pytest.mark.parametrize("n,m", [(16, 16), (16, 5), (64, 1)])
def test_record_serve_and_finished_are_bitwise(n, m):
    rng = np.random.default_rng(n + m)
    jtele, ttele = jt.init_telemetry(n), tt.init_telemetry(n, "cpu")
    full = n == m
    for _ in range(6):
        idx, wait, stepped, cost, overdue = block(rng, n, m)
        if full:
            # the sync fast path takes wait in lane order
            wait_lanes = np.empty(n, np.int32)
            wait_lanes[idx] = wait
            wait = wait_lanes
        jtele = jt.record_serve(jtele, jnp.asarray(idx), jnp.asarray(wait),
                                jnp.asarray(stepped), jnp.asarray(cost),
                                jnp.asarray(overdue), full_block=full)
        ttele = tt.record_serve(ttele, torch.from_numpy(idx),
                                torch.from_numpy(wait),
                                torch.from_numpy(stepped),
                                torch.from_numpy(cost),
                                torch.tensor(overdue), full_block=full)
        assert_tele_equal(jtele, ttele, "serve")
        fin = rng.random(n) < 0.3
        lane_cost = rng.integers(5, 22, n).astype(np.int32)
        jtele = jt.record_finished(jtele, jnp.asarray(fin),
                                   jnp.asarray(lane_cost))
        ttele = tt.record_finished(ttele, torch.from_numpy(fin),
                                   torch.from_numpy(lane_cost))
        assert_tele_equal(jtele, ttele, "finished")
    assert_stats_equal(jt.snapshot_device(jt.telemetry_shard(jtele),
                                          jnp.asarray([6])),
                       tt.snapshot_device(ttele, torch.tensor(6)))


def test_full_block_fast_path_equals_the_gathered_path():
    rng = np.random.default_rng(3)
    n = 32
    a = b = tt.init_telemetry(n, "cpu")
    for _ in range(4):
        idx, wait, stepped, cost, overdue = block(rng, n, n)
        lanes = np.empty(n, np.int32)
        lanes[idx] = wait
        args = (torch.from_numpy(stepped), torch.from_numpy(cost),
                torch.tensor(overdue))
        a = tt.record_serve(a, torch.from_numpy(idx), torch.from_numpy(wait),
                            *args)
        b = tt.record_serve(b, torch.from_numpy(idx),
                            torch.from_numpy(lanes), *args, full_block=True)
    assert_tele_equal(a, b)


def test_counters_wrap_as_int32():
    tele = tt.init_telemetry(4, "cpu")
    top = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    tele = tele.replace(served=top, cost_sum=top)
    ones = torch.ones(4, dtype=torch.int32)
    out = tt.record_serve(tele, torch.arange(4, dtype=torch.int32), ones,
                          ones.bool(), ones, torch.tensor(0, dtype=torch.int32))
    assert int(out.served) == -(2 ** 31) + 3
    assert int(out.cost_sum) == -(2 ** 31) + 3


def test_format_stats_matches_repro():
    rng = np.random.default_rng(5)
    args = dict(recvs=7, serves=rng.integers(0, 9, 12),
                wait_ticks=rng.integers(0, 40, 12),
                wait_hist=rng.integers(0, 9, 8), served=84, stepped=61,
                cost_sum=400, overdue_admits=0)
    assert_stats_equal(jt.format_stats(**args), tt.format_stats(**args))
    empty = dict(args, served=0, stepped=0)
    assert tt.format_stats(**empty)["occupancy"] == 0.0
    assert tt.stats_to_jsonable(tt.format_stats(**args)) \
        == jt.stats_to_jsonable(jt.format_stats(**args))


def conservation(stats: dict, m: int) -> None:
    assert stats["served"] == stats["recvs"] * m
    assert int(stats["serves"].sum()) == stats["served"]
    assert int(stats["wait_hist"].sum()) == stats["served"]
    assert 0 <= stats["stepped"] <= stats["served"]
    assert stats["wait_ticks_total"] == int(stats["wait_ticks"].sum())


@pytest.mark.parametrize("task,n,m,engine,schedule", [
    ("Ant-v3", 8, None, "device", "fifo"),
    ("Ant-v3", 8, 4, "device", "fifo"),
    ("Ant-v3", 8, 3, "device", "sjf"),
    ("PongClassic-v5", 4, 2, "device", "fifo"),
    ("Ant-v3", 8, 4, "device-masked", "fifo"),
])
def test_pool_stats_match_repro(task, n, m, engine, schedule):
    atol = 1e-4 if task.startswith("Ant") else 0.0
    jp, tp = make_pair(task, n, m, engine=engine, schedule=schedule,
                       max_episode_steps=5)
    steps = 12
    jps, tps = rollout(jp, tp, steps, seed=1, atol=atol)
    js, ts = jp.stats(jps), tp.stats(tps)
    assert_stats_equal(js, ts, task)
    conservation(ts, tp.batch_size)
    assert ts["recvs"] == steps + 1
    # something waited, something was re-served or reset
    assert ts["served"] > ts["stepped"] > 0


def test_streams_do_not_move_with_obs():
    """``obs=False`` is the uninstrumented pool: the same served blocks,
    no counters, and ``stats()`` refuses."""
    pools = [repro_torch.make("PongClassic-v5", 4, 2, device="cpu",
                              max_episode_steps=5, obs=obs)
             for obs in (True, False)]
    states = [p.reset(repro_torch.random.PRNGKey(4)) for p in pools]
    assert states[1][0].telemetry == ()
    for t in range(10):
        compare(f"step {t}", states[0][1], states[1][1])
        a = torch.from_numpy(((states[0][1].env_id.numpy() * 5 + t) % 6)
                             .astype(np.int32))
        states = [p.step(ps, a, ts.env_id)
                  for p, (ps, ts) in zip(pools, states)]
    with pytest.raises(RuntimeError, match="obs=False"):
        pools[1].stats(states[1][0])
    conservation(pools[0].stats(states[0][0]), 2)


def test_publish_pool_stats_matches_repro():
    rng = np.random.default_rng(9)
    stats = tt.format_stats(recvs=3, serves=rng.integers(0, 4, 6),
                            wait_ticks=rng.integers(0, 9, 6),
                            wait_hist=np.array([6, 2, 1, 0, 0, 0, 0, 0]),
                            served=9, stepped=7, cost_sum=41,
                            overdue_admits=0)
    jreg, treg = jax_metrics.MetricsRegistry(), tm.MetricsRegistry()
    jax_metrics.publish_pool_stats(jreg, stats, pool="a")
    tm.publish_pool_stats(treg, stats, pool="a")
    assert treg.snapshot() == jreg.snapshot()
    assert treg.histogram("pool_wait_ticks", tt.WAIT_EDGES).counts(
        pool="a").tolist() == [6, 2, 1, 0, 0, 0, 0, 0]
