"""Subprocess helper for tests/test_torch_disaggregated.py: one process
of a job running ``train_disaggregated`` in both packages.

Of two processes (env process 0, learner process 1): ``repro``'s runs
under ``jax.distributed`` (two local host devices a process, so its env
mesh is process 0's two devices); the port's under
``torch.distributed`` over gloo, its env mesh the two shards of process
0 (``disaggregated_env_mesh(2)``).  Both train Ant-v3 N=8 for two
iterations from one seed.  Prints one JSON object: each package's
history and final params (as nested lists).

Of three processes (``cnn <dir>``: env processes 0 and 1, one shard
each, learner 2): both packages train PongClassic-v5 N=4 with the
default CNN, which ``policy_shardings`` shards over the two env
processes, for two iterations.  Prints each package's history, the
shapes the port's env process held when it gathered the policy and
its ``"policy"`` gathers after the prologue and after each iteration;
writes each package's final params to ``<dir>/<package><pid>.npz``
(``repro``'s through ``params_from_jax``, conv weights to OIHW).

Usage: python tests/_torch_disaggregated_check.py <process_id> <jax port>
       <torch port> [cnn <dir>]
"""

import json
import os
import sys

from repro.launch.mesh import initialize_multihost as jax_initialize

PID = int(sys.argv[1])
CNN = sys.argv[4:5] == ["cnn"]
jax_initialize(f"127.0.0.1:{sys.argv[2]}", num_processes=3 if CNN else 2,
               process_id=PID, local_device_count=1 if CNN else 2)

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


def shapes(tree) -> dict:
    from repro_torch.utils.tree import tree_leaves_with_path

    return {path: list(x.shape) for path, x in tree_leaves_with_path(tree)}


def save(name: str, params) -> None:
    from repro_torch.utils.tree import tree_leaves_with_path

    np.savez(os.path.join(sys.argv[5], f"{name}{PID}.npz"), **{
        path: x.numpy() for path, x in tree_leaves_with_path(params)})


def run_cnn() -> dict:
    """Both packages' ``train_disaggregated`` on PongClassic-v5 N=4 with
    the default CNN: env processes 0 and 1, learner 2."""
    from repro_torch.rl.nets import params_from_jax

    cnn_cfg = dict(total_steps=2 * 4 * STEPS, num_steps=STEPS, epochs=2,
                   minibatches=2)
    mesh = jsharding.disaggregated_env_mesh()
    pool = jax_registry.make("PongClassic-v5", num_envs=4,
                             engine="device-sharded", mesh=mesh)
    state, _, jhist = jppo.train_disaggregated(
        pool, jppo.PPOConfig(**cnn_cfg), seed=2)
    save("repro", params_from_jax(jax.tree.map(np.asarray, state.params),
                                  "cpu"))

    initialize_multihost(f"localhost:{sys.argv[3]}", 3, PID, backend="gloo")
    mesh = tsharding.disaggregated_env_mesh(2, device="cpu")
    pool = repro_torch.make("PongClassic-v5", num_envs=4,
                            engine="device-sharded", mesh=mesh)
    held, gathers = [], []
    gather = tppo.gather_policy

    def recorded(mesh, local, plan):
        if mesh is None:        # the learner's update: nothing is placed
            return gather(mesh, local, plan)
        held.append(shapes(local))
        out = gather(mesh, local, plan)
        gathers.append(mesh.counts().get("policy", 0))
        return out

    tppo.gather_policy = recorded
    try:
        state, _, thist = tppo.train_disaggregated(
            pool, tppo.PPOConfig(**cnn_cfg), seed=2)
    finally:
        tppo.gather_policy = gather
    save("port", state.params)
    return {"repro": {"history": jhist}, "port": {
        "history": thist, "held": held[:1], "gathers": gathers,
        "local_shards": mesh.local_shards}}


if __name__ == "__main__":
    torch.set_num_threads(1)
    if CNN:
        out = {"pid": PID, **run_cnn()}
    else:
        out = {"pid": PID, "repro": run_repro(), "port": run_port()}
    print(json.dumps(out))
