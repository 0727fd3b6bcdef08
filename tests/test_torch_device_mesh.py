"""``engine="device"`` and ``"device-masked"`` are the mesh engine at one
shard, as in ``repro`` (``repro/core/device_pool.py``: ``DeviceEnvPool
= MeshEnvPool``): the pool is a ``MeshEnvPool`` with ``num_shards`` 1,
and against ``repro.make(..., engine=...)`` run live its stream, its
``stats()`` and every leaf of its ``PoolState`` agree, the leading shard
dim of 1 of ``tick``, ``rng``, the per-shard counters and the global
transform state included.  Discrete leaves and keys are bitwise; float
leaves bitwise for Pong and within the stream's 1e-4 for the Ant tasks
(XLA's fused multiply-adds and ``cos`` differ from torch's in the last
bit, as tests/test_torch_pool.py states)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

from _torch_pair import (  # noqa: E402
    assert_stats_equal,
    jax_leaves,
    make_pair,
    rollout,
)
from repro_torch.core.engine import (  # noqa: E402
    MeshEnvPool,
    pool_state_to_numpy,
)

CASES = [
    # task, N, M, engine, kwargs, atol
    ("Ant-v3", 8, None, "device", {}, 1e-4),
    ("PongClassic-v5", 4, 2, "device", {"schedule": "sjf"}, 0.0),
    ("Ant-v3", 8, 4, "device-masked", {}, 1e-4),
    ("AntNorm-v3", 8, None, "device", {}, 1e-3),
]


@pytest.mark.parametrize("task,n,m,engine,kw,atol", CASES,
                         ids=[f"{c[0]}-{c[3]}-{c[2]}" for c in CASES])
def test_one_shard_mesh_engine_equals_repros(task, n, m, engine, kw, atol):
    jp, tp = make_pair(task, n, m, engine=engine, **kw)
    assert type(tp) is MeshEnvPool and tp.num_shards == 1
    assert type(jp).__name__ == "MeshEnvPool" and jp.num_shards == 1
    jps, tps = rollout(jp, tp, 12, seed=3, atol=atol)
    assert_stats_equal(jp.stats(jps), tp.stats(tps), task)
    want = jax_leaves(jps)
    got = pool_state_to_numpy(tp, tps)
    assert set(got) == set(want)
    assert got["tick"].shape == (1,) and got["rng"].shape == (1, 2)
    assert got["telemetry.served"].shape == (1,)
    assert got["telemetry.wait_hist"].shape[0] == 1
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.issubdtype(w.dtype, np.floating) and atol:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
