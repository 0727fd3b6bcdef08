#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` for two checkouts in turns: the
model-parallel steps on a (1, 1) mesh of the card beside the unsharded
steps on the same weights, ``mesh_memory`` at each ``remat``, and the
dry run of ``qwen3-14b train_4k`` on the host beside them
(``chip_smoke.py::mesh_phase``):

    python3 scripts/mesh_ab.py PARENT [--rounds 1]

PARENT is a checkout of the parent commit (``git archive`` of it,
unpacked).  Per round: parent, change, change, parent, each in a
process of its own running that checkout's ``mesh_phase`` on that
checkout's ``src``.  One JSON line a run: each row's ms and sharded over
unsharded ratio, ``mesh_memory``'s allocator and tracker peaks and ms a
step at each ``remat``, the dry run's peak bytes, collectives and
operand bytes a rank; the card's name and power limit first.  Needs the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summary(tree: str) -> dict:
    """``mesh_phase`` of the checkout at ``tree``, reduced to its
    numbers."""
    sys.path.insert(0, tree)
    import chip_smoke

    chip_smoke.CARD = chip_smoke.card_line()
    res = chip_smoke.mesh_phase()
    rows = []
    for r in res["rows"]:
        ms = r.get("ms_per_call", r.get("ms_per_step"))
        plain = r.get("plain_ms_per_call", r.get("plain_ms_per_step"))
        kind = ("prefill" if "ms_per_call" in r else
                "train" if "timed_steps" in r else "serve")
        rows.append({"row": f"{r['model']} {kind}", "ms": ms,
                     "plain_ms": plain, "sharded_over_plain": ms / plain,
                     "peak_gb": r["peak_gb"]})
    dry = res["dryrun"]
    return {"tree": tree, "card": chip_smoke.CARD, "rows": rows,
            "memory": [{k: m[k] for k in (
                "remat", "allocator_peak_bytes", "tracker_peak_bytes",
                "ms_per_step", "flash_launches_per_step")}
                for m in res["memory"]],
            "dryrun": {"peak_bytes_per_device": dry["peak_bytes_per_device"],
                       "collectives": dry["collectives"]["total_count"],
                       "operand_bytes_per_device":
                           dry["collectives"]["total_operand_bytes"],
                       "wall_s": dry["wall_s"]}}


def main() -> int:
    ap = argparse.ArgumentParser(prog="scripts/mesh_ab.py")
    ap.add_argument("parent", help="a checkout of the parent commit")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:            # one checkout, in this process
        print("MESH_AB " + json.dumps(summary(args.run)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    parent = os.path.abspath(args.parent)
    for _ in range(args.rounds):
        for tree in (parent, ROOT, ROOT, parent):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), parent,
                 "--run", tree], capture_output=True, text=True)
            lines = [line for line in out.stdout.splitlines()
                     if line.startswith("MESH_AB ")]
            if out.returncode != 0 or not lines:
                print(out.stdout[-3000:], out.stderr[-3000:],
                      file=sys.stderr)
                return 1
            print(lines[-1].removeprefix("MESH_AB "), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
