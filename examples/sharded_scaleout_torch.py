"""Scale-out demo on the PyTorch/CUDA port: the sharded engine
(``engine="device-sharded"``) at 1 and D shards
(``examples/sharded_scaleout.py``'s arguments and prints).

The paper's headline numbers (§4.1) come from saturating all available
hardware; here the same engine splits its ``PoolState`` into D shards
and the rollout stays on the device end to end.  The D shards run solo
in this one process, on its one device (``core/engine.py::EnvMesh``), so
they are a layout, not scale-out; across processes each rank holds its
own (``launch/mesh.py::initialize_multihost``).

On the card by default (``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python examples/sharded_scaleout_torch.py --shards 4
"""

import argparse
import time

from repro_torch.core.registry import make
from repro_torch.core.xla_loop import build_random_collect_fn, frames_per_batch
from repro_torch.random import PRNGKey


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--envs-per-shard", type=int, default=16)
    ap.add_argument("--task", default="TokenCopy-v0")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="the shards' device (cuda must be present)")
    args = ap.parse_args(argv)

    print(f"device: {args.device}, shards solo in one process")
    for shards in (1, args.shards):
        n = args.envs_per_shard * shards
        pool = make(args.task, num_envs=n, engine="device-sharded",
                    num_shards=shards, device=args.device)
        dev = pool.device
        collect = build_random_collect_fn(pool, num_steps=args.steps)
        ps, ts = pool.reset(PRNGKey(0, device=dev))
        ps, ts, traj, _ = collect(ps, None, ts, PRNGKey(1, device=dev))
        float(traj.reward.sum())                     # warm-up
        t0 = time.time()
        ps, ts, traj, _ = collect(ps, None, ts, PRNGKey(2, device=dev))
        frames = float(traj.step_cost.sum())
        dt = time.time() - t0
        print(f"mesh={shards}  envs={n:4d}  "
              f"{frames / dt:>12,.0f} steps/s  "
              f"(~{frames_per_batch(pool) * args.steps} frames/collect)")


if __name__ == "__main__":
    main()
