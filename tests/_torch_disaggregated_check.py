"""Subprocess helper for tests/test_torch_disaggregated.py: one of two
processes running ``train_disaggregated`` in both packages, env process
0 and learner process 1.

``repro``'s runs under ``jax.distributed`` (two local host devices a
process, so its env mesh is process 0's two devices); the port's under
``torch.distributed`` over gloo, its env mesh the two shards of process
0 (``disaggregated_env_mesh(2)``).  Both train Ant-v3 N=8 for two
iterations from one seed.  Prints one JSON object: each package's
history and final params (as nested lists).

Usage: python tests/_torch_disaggregated_check.py <process_id> <jax port>
       <torch port>
"""

import json
import sys

from repro.launch.mesh import initialize_multihost as jax_initialize

PID = int(sys.argv[1])
jax_initialize(f"127.0.0.1:{sys.argv[2]}", num_processes=2, process_id=PID,
               local_device_count=2)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro.distributed.sharding as jsharding  # noqa: E402
import repro.rl.ppo as jppo  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.distributed.sharding as tsharding  # noqa: E402
import repro_torch.rl.ppo as tppo  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    initialize_multihost,
    make_env_mesh,
)

N, STEPS, ITERS = 8, 4, 2
HIDDEN = (16, 16)


def cfg(ppo):
    return ppo.PPOConfig(total_steps=ITERS * N * STEPS, num_steps=STEPS,
                         epochs=2, minibatches=2)


def run_repro() -> dict:
    mesh = jsharding.disaggregated_env_mesh()
    pool = jax_registry.make("Ant-v3", num_envs=N, engine="device-sharded",
                             mesh=mesh)
    state, _, hist = jppo.train_disaggregated(pool, cfg(jppo), seed=2,
                                              hidden=HIDDEN)
    return {"history": hist, "params": jax.tree.map(
        lambda x: np.asarray(x).tolist(), state.params),
        "shards": int(pool.num_shards)}


def run_port() -> dict:
    initialize_multihost(f"localhost:{sys.argv[3]}", 2, PID, backend="gloo")
    mesh = tsharding.disaggregated_env_mesh(2, device="cpu")
    pool = repro_torch.make("Ant-v3", num_envs=N, engine="device-sharded",
                            mesh=mesh)
    state, _, hist = tppo.train_disaggregated(pool, cfg(tppo), seed=2,
                                              hidden=HIDDEN)
    # a mesh over both processes overlaps the learner: refused
    both = repro_torch.make("Ant-v3", num_envs=N, engine="device-sharded",
                            mesh=make_env_mesh(2, "cpu"))
    try:
        tppo.train_disaggregated(both, cfg(tppo), hidden=HIDDEN)
        overlap = "accepted"
    except ValueError as e:
        overlap = str(e)
    return {"history": hist, "overlap": overlap, "params": {
        k: {kk: vv.numpy().tolist() for kk, vv in v.items()}
        if isinstance(v, dict) else v.numpy().tolist()
        for k, v in state.params.items()},
        "shards": pool.num_shards, "local_shards": mesh.local_shards}


if __name__ == "__main__":
    torch.set_num_threads(1)
    out = {"pid": PID, "repro": run_repro(), "port": run_port()}
    print(json.dumps(out))
