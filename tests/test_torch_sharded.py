"""The port's sharded engine (``engine="device-sharded"``,
``core/engine.py::MeshEnvPool``) on the CPU.

Against ``repro``: tests/_torch_sharded_check.py runs both packages at
D = 2 and 4 shards in fresh interpreters (``repro`` needs D host devices
forced before jax is imported; this process sees one), every block
compared and ``stats()`` bitwise: Ant within 1e-4 (an ulp of cos/sin),
CartPole 1e-5, NormalizeObs values 1e-3 and moments 1e-6, the rest
bitwise.  In this process: sync streams invariant to D, the collective
audit of a recv, the validation errors, transform-state checkpoints
across mesh sizes and policy placement.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import repro_torch  # noqa: E402
from repro_torch.core.engine import DeviceEnvPool, MeshEnvPool  # noqa: E402
from repro_torch.core.registry import (  # noqa: E402
    _registry,
    default_transforms,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one OpenMP thread a child: the suite's xdist workers share the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
CHECK = os.path.join(ROOT, "tests", "_torch_sharded_check.py")

# the helper's cases, by its names (task-N-M-schedule)
CASES = (
    "Ant-v3-8-None-fifo", "Ant-v3-8-4-fifo", "CartPole-v1-8-4-sjf",
    "AntSkew-v3-8-4-hierarchical", "AntSkew-v3-8-None-hierarchical",
    "TokenCopy-v0-8-4-hierarchical", "PongClassic-v5-4-None-fifo",
    "AntNorm-v3-8-None-fifo", "AntNorm-v3-8-4-hierarchical", "masked",
)


@pytest.fixture(scope="module")
def runs():
    """Both mesh sizes at once, one interpreter each."""
    procs = {d: subprocess.Popen([sys.executable, CHECK, str(d)], env=ENV,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for d in (2, 4)}
    out = {}
    for d, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, stderr[-3000:]
        out[d] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_pool_matches_repro(runs, d, case):
    assert runs[d][case] == "ok", runs[d][case]


@pytest.mark.parametrize("d", [2, 4])
def test_pong_async_and_hierarchical_overdue_band_match_repro(runs, d):
    """Pong's image path in async sjf (N=8, M=4, so async at D=2 and
    at D=4), and the hierarchical schedule's
    overdue band taken (AntSkew-v3 at ``sched_patience=0.25``)."""
    assert runs[d]["PongClassic-v5-8-4-sjf"] == "ok", runs[d]
    assert runs[d]["overdue_admits"] > 0


@pytest.mark.parametrize("driver", ["train_device", "train_pipelined"])
def test_training_over_a_sharded_pool_matches_repro(runs, driver):
    """One iteration over a D=2 pool against ``repro``'s over a 2-device
    mesh: params within 1e-5, the history within 1e-4."""
    got = runs[2][driver]
    assert isinstance(got, dict), got
    assert got["params"] < 1e-5 and got["history"] < 1e-4, got


def test_cnn_training_over_a_sharded_pool_matches_repro(runs):
    """PongClassic-v5's default CNN over a D=2 pool: ``repro`` shards 11
    of its 12 leaves over its 2 devices; one iteration of
    ``train_device`` in both packages, final params within 1e-5 and the
    losses and metrics within ``test_torch_ppo.py``'s 1e-4 relative."""
    got = runs[2]["cnn"]
    assert isinstance(got, dict), got
    assert got["sharded_leaves"] == 11, got
    assert got["params"] < 1e-5, got
    assert all(v <= 1.0 for v in got["history"].values()), got


# ---------------------------------------------------------------------- #
# in this process: the port alone
# ---------------------------------------------------------------------- #
def sharded(task, n, m=None, d=2, **kw):
    return repro_torch.make(task, num_envs=n, batch_size=m,
                            engine="device-sharded", num_shards=d,
                            device="cpu", **kw)


def sync_stream(pool, steps=6):
    """Every block's (ids, obs, reward, done), rows in env-id order."""
    act = pool.spec.act_spec
    hi = int(act.maximum) if act.maximum is not None else 1
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    out = []
    for t in range(steps):
        order = torch.argsort(ts.env_id)
        out.append([x[order].numpy() for x in (ts.env_id, ts.obs,
                                               ts.reward, ts.done)])
        ids = ts.env_id
        if act.dtype.is_floating_point:
            a = ((ids[:, None] * 7 + t) % 5).float() / 5 - 0.4
            a = a.expand((len(ids),) + tuple(act.shape))
        else:
            a = ((ids * 7 + t) % (hi + 1)).to(act.dtype)
        ps, ts = pool.step(ps, a, ids)
    return out, ps


@pytest.mark.parametrize("task,n", [
    ("TokenCopy-v0", 8), ("CartPole-v1", 8), ("Ant-v3", 8),
    ("PongClassic-v5", 4),
])
def test_sync_streams_are_invariant_to_mesh_size(task, n):
    """D = 1, 2 and 4 and the one-device engine: the same rows, bitwise,
    and the same counters; D = 2 and 4 also in the same order."""
    env = _registry()[task][0]()
    tfs = default_transforms(task)
    pools = [DeviceEnvPool(env, n, transforms=tfs, device="cpu")] + [
        MeshEnvPool(env, n, mesh=d, transforms=tfs, device="cpu")
        for d in (1, 2, 4)]
    runs_ = [sync_stream(p) for p in pools]
    for (blocks, ps), pool in zip(runs_[1:], pools[1:]):
        for t, (got, want) in enumerate(zip(blocks, runs_[0][0])):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{pool.num_shards} {t}")
        s, s0 = pool.stats(ps), pools[0].stats(runs_[0][1])
        for k in s:
            np.testing.assert_array_equal(s[k], s0[k], err_msg=k)
    # D > 1 sync blocks come in env-id order
    ps, ts = pools[2].reset(repro_torch.random.PRNGKey(0))
    assert ts.env_id.tolist() == list(range(n))


def test_recv_collectives_are_the_two_allowed_families():
    """fifo and sjf issue none; hierarchical one gather of the (D, C)
    candidate costs; NormalizeObs two gathers of its (D, *obs) sums.
    Every one moves statistics far smaller than a served block."""
    want = {
        ("Ant-v3", "fifo"): {},
        ("Ant-v3", "sjf"): {},
        ("AntSkew-v3", "hierarchical"): {"candidates": 1},
        ("AntNorm-v3", "fifo"): {"moments": 2},
        ("AntNorm-v3", "hierarchical"): {"candidates": 1, "moments": 2},
    }
    for (task, schedule), counts in want.items():
        pool = sharded(task, 64, 32, d=2, schedule=schedule)
        ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
        block = ts.obs.numel() * 4      # one served block of obs, f32
        for t in range(3):
            pool.mesh.reset_log()
            ps, ts = pool.step(ps, torch.zeros((32, 8)), ts.env_id)
            assert pool.mesh.counts() == counts, (task, schedule, t)
            for kind, nbytes in pool.mesh.log:
                assert nbytes * 4 <= block, (kind, nbytes, block)
        c = min(32, 2 * 16)
        if "candidates" in counts:
            assert ("candidates", 2 * c * 4) in pool.mesh.log


def test_one_env_step_launch_per_recv_for_all_local_shards(monkeypatch):
    """The selected rows of every local shard go through one env_step
    (and one render) call a recv, at any D."""
    import repro_torch.envs.atari_like as atari
    import repro_torch.envs.mujoco_like as mujoco

    calls = {"env_step": 0, "render": 0}
    step, render = mujoco.env_multi_step, atari.pong_render

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mujoco, "env_multi_step", count("env_step", step))
    monkeypatch.setattr(atari, "pong_render", count("render", render))
    for d in (1, 4):
        for task, key in (("Ant-v3", "env_step"), ("PongClassic-v5",
                                                   "render")):
            pool = sharded(task, 8, d=d)
            ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
            a = torch.zeros((8,) + tuple(pool.spec.act_spec.shape),
                            dtype=pool.spec.act_spec.dtype)
            calls[key] = 0
            pool.step(ps, a, ts.env_id)
            assert calls[key] == 1, (task, d, calls)


@pytest.mark.parametrize("kwargs,error", [
    ({"num_envs": 6, "num_shards": 4}, "num_envs=6 % num_shards=4"),
    ({"num_envs": 8, "batch_size": 6, "num_shards": 4},
     "batch_size=6 % num_shards=4"),
    ({"num_envs": 8, "batch_size": 12, "num_shards": 2}, "cannot exceed"),
    ({"num_envs": 8, "schedule": "hierarchical", "engine": "device"},
     "needs a device mesh"),
    ({"num_envs": 8, "schedule": "hierarchical",
      "engine": "device-masked"}, "needs a device mesh"),
    ({"num_envs": 8, "num_shards": 2, "sched_patience": 0.0},
     "patience must be > 0"),
])
def test_the_sharded_engine_refuses_what_repro_refuses(kwargs, error):
    kw = {"engine": "device-sharded", **kwargs}
    with pytest.raises(ValueError, match=error):
        repro_torch.make("Ant-v3", device="cpu", **kw)


def test_mesh_of_several_processes_needs_a_job():
    from repro_torch.core.engine import EnvMesh, make_env_mesh

    with pytest.raises(RuntimeError, match="torch.distributed"):
        EnvMesh(2, "cpu", ranks=(0, 1))
    with pytest.raises(ValueError, match="sorted"):
        EnvMesh(2, "cpu", ranks=(1, 0))
    mesh = make_env_mesh(4, "cpu")
    assert (mesh.num_shards, mesh.local_shards, mesh.first_shard,
            mesh.is_multiprocess) == (4, 4, 0, False)
    with pytest.raises(ValueError, match="differs"):
        MeshEnvPool(_registry()["Ant-v3"][0](), 8, mesh=mesh,
                    device="cuda:0")


def test_transform_state_checkpoints_cross_mesh_sizes(tmp_path):
    """NormalizeObs's moments saved at D=2 in the canonical form (one copy)
    restore onto D=4 and onto the one-device engine, and back."""
    from repro_torch.checkpoint.store import CheckpointStore

    pool = sharded("AntNorm-v3", 8, d=2)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    for _ in range(3):
        ps, ts = pool.step(ps, torch.zeros((8, 8)), ts.env_id)
    store = CheckpointStore(str(tmp_path))
    assert pool.save_transform_state(store, 3, ps).endswith("step_3")
    saved = {k: v[0] for k, v in ps.tf_state[0].items()}
    four = sharded("AntNorm-v3", 8, d=4)
    got = four.restore_transform_state(store, 3, four.init(
        repro_torch.random.PRNGKey(1)))
    one = repro_torch.make("AntNorm-v3", 8, device="cpu")
    got1 = one.restore_transform_state(store, 3, one.init(
        repro_torch.random.PRNGKey(1)))
    for k, v in saved.items():
        assert got.tf_state[0][k].shape == (4,) + tuple(v.shape)
        for row in got.tf_state[0][k]:
            np.testing.assert_array_equal(row.numpy(), v.numpy())
        assert got1.tf_state[0][k].shape == (1,) + tuple(v.shape)
        np.testing.assert_array_equal(got1.tf_state[0][k][0].numpy(),
                                      v.numpy())
    store1 = CheckpointStore(str(tmp_path / "one"))
    one.save_transform_state(store1, 1, got1)
    back = pool.restore_transform_state(store1, 1, ps)
    for k, v in saved.items():
        np.testing.assert_array_equal(back.tf_state[0][k][1].numpy(),
                                      v.numpy())


def test_policy_placement_replicates_on_a_solo_mesh():
    """``policy_shardings``' plan shards a policy past 2^20 params over a
    mesh of several shards and replicates a smaller one; in solo every
    shard shares the device, so ``place_params`` replicates either."""
    from repro_torch.distributed.sharding import policy_shardings
    from repro_torch.rl.policy_lm import LMPolicy

    pool = sharded("TokenCopy-v0", 8, d=2)
    small = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    big = {"w": torch.zeros(1024, 1026), "b": torch.zeros(3)}
    assert policy_shardings(pool.mesh, small) == {"w": None, "b": None}
    assert policy_shardings(pool.mesh, big) == {"w": 1, "b": None}
    one = repro_torch.make("TokenCopy-v0", 8, device="cpu")
    assert policy_shardings(sharded("TokenCopy-v0", 8, d=1).mesh, big) \
        == {"w": None, "b": None}
    pol = LMPolicy(pool.spec, device="cpu")
    placed = pol.place_params(big, pool)
    assert placed["w"].device == pool.device
    # the one-device engine is the mesh engine at one shard: replicated,
    # the leaves already on its device (no copy)
    assert one.num_shards == 1
    placed = pol.place_params(small, one)
    assert all(placed[k] is small[k] for k in small)


def test_replicate_and_put_batch_in_solo():
    pool = sharded("Ant-v3", 8, 4, d=2)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    assert pool.block_rows is None and not pool.is_multiprocess
    assert pool.replicate(ts.env_id) is ts.env_id
    got = pool.put_batch(np.arange(4))
    assert got.tolist() == [0, 1, 2, 3]
    assert pool.device_put(ps) is ps
    plan = pool.state_shardings(ps)
    assert plan.tick == ("env",) and plan.r_reward == ("env",)
