#!/usr/bin/env python3
"""The full-width LM train step (``chip_smoke.py``'s ``drive_lm_train``:
qwen3-0.6b, B=8, S=512, blocked, bf16 compute, AdamW) with the stacked
layer parameters split once a forward (``models/transformer.py::
unstack_layers``, ``torch.unbind``) against each layer's parameters
indexed out of the stacked leaves one by one (``v[i]``), in turns:

    python3 scripts/train_step_ab.py [--rounds 1]

Per round: unbind, index, index, unbind; one JSON line a run (ms a step,
device busy, idle share, kernels a step, the top kernel families, the
plain attention backward, peak memory, the losses), the card's name and
power limit first.  Under autograd each index view's backward adds a
zero-filled gradient of the whole stacked leaf into it; unbind's
backward stacks the layers' gradients once.  The losses must agree
bitwise.  Needs the card.

The per-layer indexing is the train step's first version, which the
port no longer runs: it is kept here, as ``scripts/*_ab.py`` keep the
variants they compare, so that PERF.md's numbers for the split can be
measured again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("ms_per_step", "tokens_per_s", "model_tflops_per_s",
        "device_busy_ms_per_step", "device_idle_share", "kernels_per_step",
        "top3_kernels_ms_per_step", "attn_backward_ms_per_step",
        "attn_backward_alone_ms_per_step", "peak_memory_gb", "losses")


def indexed(layers: dict, n: int) -> list[dict]:
    """Layer ``i``'s parameters as ``v[i]`` views of the stacked leaves."""
    def one(tree, i):
        return {k: one(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    return [one(layers, i) for i in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_step_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.build import library
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    print(cs.CARD, flush=True)
    library()
    unbind = transformer.unstack_layers
    losses = set()
    try:
        for r in range(args.rounds):
            for variant in ("unbind", "index", "index", "unbind"):
                transformer.unstack_layers = (unbind if variant == "unbind"
                                              else indexed)
                row = cs.drive_lm_train()
                losses.add(tuple(row["losses"]))
                print(json.dumps({"round": r, "variant": variant,
                                  **{k: row[k] for k in KEYS},
                                  "card": cs.CARD}), flush=True)
    finally:
        transformer.unstack_layers = unbind
    if len(losses) != 1:
        print(f"train_step_ab: the variants' losses differ: {losses}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
