"""Subprocess helper for tests/test_torch_multihost.py: the port's
sharded engine in two process topologies, printing one JSON object per
process so the parent can hold them to each other.

  * ``solo`` — one process holding both shards of a mesh of 2;
  * ``rank <process_id> <port>`` — one of TWO processes joined over
    ``torch.distributed`` (gloo, a TCP store on localhost) by
    ``launch.mesh.initialize_multihost``, one shard each.

Each runs the same scripted rollouts, hashing every block as the whole
mesh sees it (``pool.replicate``, the test's host read), and reports
``stats()``, the collectives each recv issued (``EnvMesh.log``), and the
params after one iteration of ``train_device`` and ``train_pipelined``.
Then one iteration of ``train_device`` over PongClassic-v5 with the
default CNN (past 2^20 parameters, so ``policy_shardings`` shards 11 of
its 12 leaves over the two shards): its losses, the shapes of the
params it gathered from and of its AdamW moments, its ``"policy"``
gathers an iteration, and its final params written to
``<dir>/<solo|rank0|rank1>.npz``.  No JAX is imported.

Usage:
  python tests/_torch_multihost_check.py solo <dir>
  python tests/_torch_multihost_check.py rank <process_id> <port> <dir>
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch

import repro_torch
from repro_torch.launch.mesh import initialize_multihost, multihost_info
from repro_torch.obs.telemetry import stats_to_jsonable
import repro_torch.rl.ppo as tppo
from repro_torch.rl import PPOConfig, train_device, train_pipelined
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

MODE = sys.argv[1] if len(sys.argv) > 1 else "solo"
if MODE == "rank":
    initialize_multihost(f"localhost:{sys.argv[3]}", 2, int(sys.argv[2]),
                         backend="gloo")
elif MODE != "solo":  # pragma: no cover
    raise SystemExit(f"unknown mode {MODE!r}")

# (task, N, M, schedule): plain fifo, the hierarchical schedule with
# NormalizeObs (both collective families), Pong's image path
ROLLOUTS = [
    ("TokenCopy-v0", 8, None, "fifo"),
    ("Ant-v3", 8, 4, "fifo"),
    ("AntNorm-v3", 16, 8, "hierarchical"),
    ("PongClassic-v5", 4, None, "sjf"),
]
STEPS = 6


def scripted_rollout(task, n, m, schedule) -> dict:
    pool = repro_torch.make(task, num_envs=n, batch_size=m,
                            engine="device-sharded", num_shards=2,
                            schedule=schedule, device="cpu")
    act = pool.spec.act_spec
    hi = int(act.maximum) if act.maximum is not None else 1
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    sha = hashlib.sha256()
    per_recv = []
    for t in range(STEPS):
        obs, rew, done, ids = pool.replicate(
            (ts.obs, ts.reward, ts.done, ts.env_id))
        for x in (obs, rew, done, ids):
            sha.update(np.ascontiguousarray(x.numpy()).tobytes())
        if act.dtype.is_floating_point:
            a = (((ids[:, None] * 7 + t) % 5).float() / 5 - 0.4).expand(
                (len(ids),) + tuple(act.shape))
        else:
            a = ((ids * 7 + t) % (hi + 1)).to(act.dtype)
        pool.mesh.reset_log()
        ps, ts = pool.step(ps, pool.put_batch(a), ts.env_id)
        per_recv.append(list(map(list, pool.mesh.log)))
    return {"sha": sha.hexdigest(), "stats": stats_to_jsonable(
        pool.stats(ps)), "collectives": per_recv,
        "block": int(ts.env_id.shape[0])}


def trained(driver) -> list:
    pool = repro_torch.make("Ant-v3", num_envs=8, engine="device-sharded",
                            num_shards=2, device="cpu")
    cfg = PPOConfig(total_steps=32, num_steps=4, epochs=1, minibatches=2)
    state, _, history = driver(pool, cfg, seed=1, hidden=(8,))
    return {"params": [float(x.double().sum()) for x in
                       tree_leaves(state.params)],
            "loss": [h["loss"] for h in history]}


def shapes(tree) -> dict:
    return {path: list(x.shape) for path, x in tree_leaves_with_path(tree)}


def trained_cnn(out_dir: str) -> dict:
    """One iteration of ``train_device`` over PongClassic-v5 N=4 at D=2
    with the default CNN; the params each ``gather_policy`` call was
    handed are the ones this process held."""
    pool = repro_torch.make("PongClassic-v5", num_envs=4,
                            engine="device-sharded", num_shards=2,
                            device="cpu")
    cfg = PPOConfig(total_steps=4 * 8, num_steps=8, epochs=2, minibatches=2)
    held, gathers = [], []
    gather = tppo.gather_policy

    def recorded(mesh, local, plan):
        held.append(shapes(local))
        return gather(mesh, local, plan)

    tppo.gather_policy = recorded
    try:
        state, _, history = train_device(
            pool, cfg, seed=1, log_fn=lambda r: gathers.append(
                pool.mesh.counts().get("policy", 0)))
    finally:
        tppo.gather_policy = gather
    name = "solo" if MODE == "solo" else f"rank{sys.argv[2]}"
    np.savez(os.path.join(out_dir, f"{name}.npz"), **{
        path: x.numpy() for path, x in tree_leaves_with_path(state.params)})
    return {"loss": [h["loss"] for h in history], "held": held[0],
            "mu": shapes(state.opt.mu), "nu": shapes(state.opt.nu),
            "whole": shapes(state.params), "policy_gathers": gathers}


def main() -> dict:
    return {
        "meta": multihost_info(),
        "rollouts": {r[0]: scripted_rollout(*r) for r in ROLLOUTS},
        "train_device": trained(train_device),
        "train_pipelined": trained(train_pipelined),
        "cnn": trained_cnn(sys.argv[-1]),
    }


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(main()))
