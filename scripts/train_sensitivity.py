#!/usr/bin/env python3
"""How far two f32 summation orders set ``train_device`` apart, on the
CPU: each run trains twice from one seed, with PyTorch's oneDNN convs
and with its plain ones, and prints the largest difference between the
two runs' final weights.

    PYTHONPATH=src python3 scripts/train_sensitivity.py
    PYTHONPATH=src python3 scripts/train_sensitivity.py --task Ant-v3 \\
        --lanes 8 --seeds 0 1 2 --epochs 1 --minibatches 2

Once a ReLU whose input sits at zero opens under one order and not the
other, Adam moves the weights apart by up to the learning rate a step,
so the difference is either rounding (1e-7) or of the order of the
learning rate.  That is why the card-vs-CPU check of ``chip_smoke.py``
runs four updates, not ``PPOConfig``'s 32.  The defaults are the CPU
tests' size: 8 steps, 2 iterations, hidden (32, 32), 5-step episodes.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.rl.ppo import PPOConfig, train_device  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402


def final_params(args, lanes: int, seed: int, onednn: bool) -> dict:
    torch.backends.mkldnn.enabled = onednn
    pool = repro_torch.make(args.task, num_envs=lanes, device="cpu",
                            max_episode_steps=5)
    cfg = PPOConfig(total_steps=2 * 8 * lanes, num_steps=8,
                    epochs=args.epochs, minibatches=args.minibatches)
    state, _, _ = train_device(pool, cfg, seed=seed, hidden=(32, 32))
    return dict(tree_leaves_with_path(state.params))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="PongClassic-v5")
    ap.add_argument("--lanes", type=int, nargs="+", default=[4, 8, 16, 32])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    args = ap.parse_args()
    print(f"{args.task}, {args.epochs} epochs x {args.minibatches} "
          "minibatches, 2 iterations: max |oneDNN - plain| in the weights")
    for lanes in args.lanes:
        diffs = []
        for seed in args.seeds:
            a = final_params(args, lanes, seed, True)
            b = final_params(args, lanes, seed, False)
            diffs.append(max(float((a[k] - b[k]).abs().max()) for k in a))
        print(f"N={lanes}: " + ", ".join(
            f"seed {s} {d:.3g}" for s, d in zip(args.seeds, diffs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
