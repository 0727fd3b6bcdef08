"""Paper Figure 2 demo, scheduler edition, on the PyTorch/CUDA port
(``examples/async_vs_sync.py``'s rows and prints): why async
(batch_size < num_envs) wins when step cost varies, and why the
*selection policy* (``repro_torch.make(..., schedule=...)``,
core/scheduler.py) is a further throughput lever on long-tail-skew
workloads.

Workload: ``TokenSkew-v0``: 25% of episodes carry an 8x decode-cost
multiplier (a serving mix where some requests run a far larger model).
Each recv's fused multi-substep pads its block to the block max cost, so
one heavy lane in a cheap block multiplies the block's latency; ``sjf``
keeps blocks cost-homogeneous, ``hierarchical`` aligns heavy bursts
across shards of the sharded engine.  The engines are the ones
``repro_torch.make`` registers: ``device`` and ``device-sharded`` (its
``MESH`` shards, default 4, share the one device).

On the card by default (``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python examples/async_vs_sync_torch.py [--device cpu]
"""

import argparse
import os
import time

import repro_torch

MESH = int(os.environ.get("MESH", "4"))
TASK = "TokenSkew-v0"


def measure(engine: str, num_envs: int, batch_size: int | None,
            schedule: str = "fifo", steps: int = 48, iters: int = 3,
            device: str = "cuda", **kwargs) -> float:
    pool = repro_torch.make(TASK, num_envs=num_envs, batch_size=batch_size,
                            engine=engine, schedule=schedule, device=device,
                            **kwargs)
    key = repro_torch.random.PRNGKey
    collect = repro_torch.build_random_collect_fn(pool, num_steps=steps)
    ps, ts = pool.reset(key(0, device=pool.device))
    ps, ts, traj, _ = collect(ps, None, ts, key(1, device=pool.device))
    float(traj.reward.sum())                     # warm-up, on the card
    frames = 0.0
    t0 = time.time()
    for i in range(iters):
        ps, ts, traj, _ = collect(ps, None, ts, key(2 + i, device=pool.device))
        frames += float(traj.step_cost.sum())
    return frames / (time.time() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the pools' device (cuda must be present)")
    args = ap.parse_args(argv)
    dev = args.device
    print(f"== {TASK}: 25% heavy episodes (8x decode cost) ==")

    print("\n-- async vs sync (device engine, schedule=fifo) --")
    rows = [
        ("sync   N=64 M=64", measure("device", 64, 64, device=dev)),
        ("async  N=64 M=16", measure("device", 64, 16, device=dev)),
        ("async  N=128 M=16", measure("device", 128, 16, device=dev)),
    ]
    base = rows[0][1]
    for name, fps in rows:
        print(f"  {name}: {fps:>10,.0f} tokens/s  ({fps/base:4.2f}x sync)")

    print(f"\n-- scheduling policy (device-sharded, mesh={MESH}, "
          f"N={16*MESH} M={4*MESH}) --")
    rows = [
        (s, measure("device-sharded", 16 * MESH, 4 * MESH, schedule=s,
                    num_shards=MESH, device=dev))
        for s in ("fifo", "sjf", "hierarchical")
    ]
    base = rows[0][1]
    for name, fps in rows:
        print(f"  {name:>12}: {fps:>10,.0f} tokens/s  ({fps/base:4.2f}x fifo)")
    print("  (sjf trades starvation of heavy lanes for throughput; "
          "hierarchical serves them in cross-shard-aligned bursts)")


if __name__ == "__main__":
    main()
