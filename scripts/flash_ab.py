#!/usr/bin/env python3
"""Compare variants of ``src/repro_torch/csrc/flash_attention.cu`` on one
CUDA card: each checked against the plain version, then timed in turns.

    python3 scripts/flash_ab.py make DIR [REF]   # where git is: the variants
    python3 scripts/flash_ab.py run DIR          # on the card

``make`` writes three sources into DIR: ``current.cu`` (the working
tree's), ``parent.cu`` (the file at git revision REF, default HEAD) and
``no_remainder.cu`` (the working tree's without the second P.V product,
the bf16 remainder of P: it fails the bf16 gate, and only shows what the
split costs).  ``run`` builds every ``DIR/*.cu`` into a library of its
own (one ``nvcc`` each, all started together), holds each against
``mha_reference`` at small shapes (max abs err, ``rounding_excess``),
and times each with CUDA events at chip_smoke.py's main flash row (the
qwen3-0.6b prefill's calls, B=4, S=8192), case (a) (B=1, S=4096) and
case (b) (starcoder2-3b, window 4096), all bf16 (B, S, H, D) views, in
turns A, B, ..., ..., B, A, twice, with SDPA beside.  It prints one JSON
line per check and per shape, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "flash_attention.cu")
REMAINDER = "        wgmma_rs<D>(o, pr[kk], dv);\n"
CHECKS = [  # B, H, Hkv, Sq, Skv, D, causal, window
    (1, 8, 2, 1000, 1000, 128, True, 300), (2, 4, 1, 384, 640, 64, True, 0),
    (1, 2, 2, 129, 129, 32, False, 0), (2, 4, 4, 64, 64, 16, True, 0),
    (1, 16, 8, 4096, 4096, 128, True, 0)]
TIMED = [("main", 4, 16, 8, 8192, 0), ("a", 1, 16, 8, 4096, 0),
         ("b", 1, 24, 2, 8192, 4096)]   # name, B, H, Hkv, S, window; D 128


def make(out: str, ref: str) -> None:
    os.makedirs(out, exist_ok=True)
    cur = open(SRC).read()
    if REMAINDER not in cur:
        raise SystemExit("flash_ab: no remainder product in the source")
    parent = subprocess.run(
        ["git", "show", f"{ref}:src/repro_torch/csrc/flash_attention.cu"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    for name, text in (("current", cur), ("parent", parent),
                       ("no_remainder", cur.replace(REMAINDER, ""))):
        with open(os.path.join(out, name + ".cu"), "w") as f:
            f.write(text)


def build(out: str) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import SIGNATURES, _nvcc, source_flags

    names = sorted(f[:-3] for f in os.listdir(out) if f.endswith(".cu"))
    flags = source_flags(Path(SRC))
    procs = {n: subprocess.Popen(
        [_nvcc(), *flags, "-shared", os.path.join(out, n + ".cu"), "-o",
         os.path.join(out, n + ".so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    libs = {}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"flash_ab: nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, n + ".so"))
        lib.flash_attention_launch.argtypes = SIGNATURES[
            "flash_attention_launch"]
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[n] = lib
    return libs


def run(out: str) -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention.ref import (mha_reference,
                                                         rounding_excess)

    libs = build(out)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(B, S, heads, D):
        return torch.randn((B, S, heads, D), generator=gen, device="cuda"
                           ).bfloat16().transpose(1, 2)

    def call(lib, q, k, v, causal, window):
        o = torch.empty_like(q)
        B, H, Sq, D = q.shape
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            k.shape[1], Sq, k.shape[2], D, int(causal), window, D ** -0.5,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_ab: launch returned {err}")
        return o

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for B, H, Hkv, Sq, Skv, D, causal, window in CHECKS:
        q, k, v = (draw(B, Sq, H, D), draw(B, Skv, Hkv, D),
                   draw(B, Skv, Hkv, D))
        want = mha_reference(q, k, v, causal=causal, window=window)
        exact = mha_reference(q.float(), k.float(), v.float(),
                              causal=causal, window=window)
        for n, lib in libs.items():
            got = call(lib, q, k, v, causal, window)
            print(json.dumps({
                "variant": n, "shape": [B, H, Hkv, Sq, Skv, D, causal,
                                        window],
                "max_abs_err": float((got.float() - want.float()).abs()
                                     .max()),
                "rounding_excess": rounding_excess(got, exact)}), flush=True)
    for name, B, H, Hkv, S, W in TIMED:
        q, k, v = (draw(B, S, H, 128), draw(B, S, Hkv, 128),
                   draw(B, S, Hkv, 128))
        times = {}
        for n in (list(libs) + list(libs)[::-1]) * 2:
            times.setdefault(n, []).append(
                time_ms(lambda: call(libs[n], q, k, v, True, W)))
        if W:
            pos = torch.arange(S, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - W)
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
        else:
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        print(json.dumps({"shape": name, "ms": {n: sorted(t) for n, t in
                                                times.items()},
                          "sdpa_ms": sdpa}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "make":
        make(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "HEAD")
    elif len(sys.argv) == 3 and sys.argv[1] == "run":
        run(sys.argv[2])
    else:
        raise SystemExit(__doc__)
