#!/usr/bin/env python3
"""The thread engine's rate against its worker count, with and without
the step lock of ``repro_torch/core/host_pool.py`` (``_STEP_LOCK``).

    python3 scripts/host_threads.py [--device cpu|cuda] [--task Ant-v3]
                                    [--envs 16] [--recvs 6]

For each of the for-loop engine and the thread engine at 1, 2, 4 and 8
workers, locked and unlocked: a sync pool of ``--envs`` envs, one warm-up
recv, then ``--recvs`` timed recvs of zero actions; one JSON line a run
(env steps/s), the card's name and power limit first when the device is
the card.  Unlocked, every worker dispatches its eager ops at once and
they hand the GIL to each other between ops.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rate(task: str, n: int, recvs: int, engine: str, device: str,
         threads: int | None) -> float:
    import numpy as np
    import torch

    import repro_torch

    pool = repro_torch.make(task, num_envs=n, engine=engine,
                            num_threads=threads, device=device)
    act = pool.spec.act_spec
    a = np.zeros((n,) + tuple(act.shape), np.float32 if
                 act.dtype.is_floating_point else np.int32)
    try:
        out = pool.step(a, pool.reset()["env_id"])
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(recvs):
            out = pool.step(a, out["env_id"])
        if device != "cpu":
            torch.cuda.synchronize()
        return n * recvs / (time.perf_counter() - t0)
    finally:
        pool.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--task", default="Ant-v3")
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--recvs", type=int, default=6)
    args = ap.parse_args()
    from repro_torch.core import host_pool

    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps({"card": card}), flush=True)
    locked = host_pool._STEP_LOCK
    runs = [("forloop", None, True)] + [
        ("thread", k, lock) for lock in (True, False) for k in (1, 2, 4, 8)]
    for engine, threads, lock in runs:
        host_pool._STEP_LOCK = locked if lock else contextlib.nullcontext()
        r = rate(args.task, args.envs, args.recvs, engine, args.device,
                 threads)
        print(json.dumps({"task": args.task, "device": args.device,
                          "num_envs": args.envs, "engine": engine,
                          "num_threads": threads, "step_lock": lock,
                          "env_steps_per_s": r}), flush=True)
    host_pool._STEP_LOCK = locked
    return 0


if __name__ == "__main__":
    sys.exit(main())
