#!/usr/bin/env python3
"""Compare variants of the render and grayscale kernels of
``src/repro_torch/csrc/image.cu`` on one CUDA card, and the pools'
device time of two checkouts.

    python3 scripts/image_ab.py make DIR [REF]   # where git is
    python3 scripts/image_ab.py run DIR          # on the card
    python3 scripts/image_ab.py pools DIR        # on the card

``make`` writes into DIR ``current.cu`` (the working tree's image.cu),
``parent.cu`` (the file at git revision REF, default HEAD), variants of
the current render, each a text patch of it: ``b<k>`` launches k blocks
of 8 warps an SM (its ``__launch_bounds__`` and the plan), ``cs``
stores with ``st.global.cs``, ``bulk`` stages two rows at a time in
shared memory and stores them with one bulk copy
(``cp.async.bulk.global.shared::cta``); and of the current grayscale:
``gray_b8`` (8 blocks an SM), ``gray_u4`` (four groups of 16 pixels a
thread per turn), ``gray_ldcs`` (``__ldcs`` loads).  It also unpacks
the checkout at REF into ``DIR/parent_tree`` for ``pools``.

``run`` builds every ``DIR/*.cu`` into a library of its own (one
``nvcc`` each, all started together, with ``-Xptxas -v``: registers and
spills of the two kernels are printed), holds each render and grayscale
bitwise against the plain versions at N = 1024 (chip_smoke.py's inputs),
and times each with ``chip_smoke.time_ms`` in turns A, B, ..., B, A:
the render, grayscale of random screens, and the render followed by
grayscale of its output, as a PongClassic recv runs them; then a memset
of the render's 103.2 MB, the write rate the card reaches.

``pools`` runs the device time per recv (chip_smoke.py's
``drive_pool`` profile) of Ant-v3 N=4096 sync and M=2048 async and
PongClassic-v5 N=1024 sync from ``DIR/parent_tree`` and from this
checkout, each in its own process, in turns parent, current, current,
parent.  Both print JSON lines and the card's name and power limit.
What is not particular to these kernels lives in ``ab_common.py``.
"""

from __future__ import annotations

import json
import sys

from ab_common import I, L, P, ROOT, build, const, main, patch, source

RENDER_BPS = "constexpr int kRenderBlocksPerSm = {};"
GRAY_BPS = "constexpr int kGrayBlocksPerSm = {};"
STORE = ("      if (l < kRowWords) out[(long long)g * kRowWords + l] = v;\n"
         "    }\n  }\n}\n")
CS_STORE = """      if (l < kRowWords) {
        uint4* p = out + (long long)g * kRowWords + l;
        asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\\n"
                     :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
      }
    }
  }
}
"""
BULK_STORE = """      {
        const int r = g - first, slot = (r >> 1) & 1, pos = r & 1;
        uint4* buf = stage[threadIdx.x >> 5][slot];
        if (pos == 0) {   // the slot's last bulk store has read it
          if (l == 0)
            asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
          __syncwarp();
        }
        if (l < kRowWords) buf[pos * kRowWords + l] = v;
        if (pos == 1 || g + 1 == last) {
          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          __syncwarp();
          if (l == 0) {
            const uint32_t sb =
                static_cast<uint32_t>(__cvta_generic_to_shared(buf));
            asm volatile(
                "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                :: "l"(out + (long long)(g - pos) * kRowWords), "r"(sb),
                   "r"((pos + 1) * kRowWords * 16) : "memory");
            asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
          }
        }
      }
    }
  }
  if (l == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}
"""
BULK_SMEM = ("  __shared__ __align__(128) uint4 "
             "stage[kRenderWarps][2][2 * kRowWords];\n")
GRAY_LOADS = (
    "      const uint4 a0 = src[3 * i], a1 = src[3 * i + 1], "
    "a2 = src[3 * i + 2];\n"
    "      const uint4 b0 = src[3 * j], b1 = src[3 * j + 1], "
    "b2 = src[3 * j + 2];\n")
GRAY_LDCS = (
    "      const uint4 a0 = __ldcs(&src[3 * i]), a1 = __ldcs(&src[3 * i + 1]),"
    " a2 = __ldcs(&src[3 * i + 2]);\n"
    "      const uint4 b0 = __ldcs(&src[3 * j]), b1 = __ldcs(&src[3 * j + 1]),"
    " b2 = __ldcs(&src[3 * j + 2]);\n")
GRAY_LOOP = ("    for (; i + stride < groups; i += 2 * stride) {",
             "    if (i < groups) dst[i] = luma16(src[3 * i], src[3 * i + 1], "
             "src[3 * i + 2]);\n")
GRAY_U4 = """    for (; i + 3 * stride < groups; i += 4 * stride) {
      uint4 t[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 3; ++k) t[u][k] = src[3 * (i + u * stride) + k];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        dst[i + u * stride] = luma16(t[u][0], t[u][1], t[u][2]);
    }
    for (; i < groups; i += stride)
      dst[i] = luma16(src[3 * i], src[3 * i + 1], src[3 * i + 2]);
"""


def variants(cur: str) -> dict[str, str]:
    bps = const(cur, RENDER_BPS)

    def blocks(text: str, k: int) -> str:
        return patch(text, RENDER_BPS.format(bps), RENDER_BPS.format(k))

    cs = patch(cur, STORE, CS_STORE)
    bulk = patch(patch(cur, STORE, BULK_STORE),
                  "  const int l = threadIdx.x & 31;\n",
                  BULK_SMEM + "  const int l = threadIdx.x & 31;\n")
    start = cur.index(GRAY_LOOP[0])
    end = cur.index(GRAY_LOOP[1]) + len(GRAY_LOOP[1])
    gray_bps = const(cur, GRAY_BPS)
    out = {"current": cur, "cs": cs, "bulk": bulk,
           "gray_b8": patch(cur, GRAY_BPS.format(gray_bps),
                             GRAY_BPS.format(8)),
           "gray_u4": cur[:start] + GRAY_U4 + cur[end:],
           "gray_ldcs": patch(cur, GRAY_LOADS, GRAY_LDCS)}
    for k in (2, 4, 6, 8):
        if k != bps:
            out[f"b{k}"] = blocks(cur, k)
            out[f"b{k}_cs"] = blocks(cs, k)
    out["b4_bulk"] = blocks(bulk, 4) if bps != 4 else bulk
    return out


def texts(ref: str) -> dict[str, str]:
    return {"parent": source("image.cu", ref), **variants(source("image.cu"))}


def bind(name: str, text: str, lib) -> None:
    planned = "int rows, int blocks" in text
    lib.pong_render_launch.argtypes = (
        (P, P, P, P, P, I, I, I, P) if planned else (P, P, P, P, P, I, P))
    lib.grayscale_launch.argtypes = (
        (P, P, L, I, I, P) if planned else (P, P, L, P))
    lib.render_bps = const(text, RENDER_BPS) if planned else None
    lib.gray_bps = const(text, GRAY_BPS) if planned else None


def run(out: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.image import ops
    from repro_torch.kernels.image.ref import (
        grayscale_reference,
        pong_render_reference,
    )

    libs = build(out, "pong_render|grayscale", bind)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(chip_smoke.SEED)
    n = 1024
    pos = rng.uniform(0, 84, (4, n)).astype(np.float32)
    pos[:, : n // 4] = np.round(pos[:, : n // 4] * 2) / 2
    pos[:, :6] = np.array([(0, 0, 0, 84), (84, 84, 84, 0), (-3, 90, 42, 42),
                           (82.5, 40, 40, 10), (1, 20, 60, 20),
                           (90, -3, 0.5, 83.5)], np.float32).T
    bx, by, py, ey = (torch.from_numpy(p).to(dev) for p in pos)
    img = torch.from_numpy(rng.integers(0, 256, (n, 210, 160, 3),
                                        dtype=np.uint8)).to(dev)
    want_rgb = pong_render_reference(bx, by, py, ey)
    want_gray = grayscale_reference(img)
    rgb = torch.empty_like(want_rgb)
    gray = torch.empty_like(want_gray)
    npx = gray.numel()

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def render(lib):
        args = [t.data_ptr() for t in (bx, by, py, ey, rgb)] + [n]
        if lib.render_bps is not None:
            total = n * 210
            rows = max(1, -(-total // (sms * lib.render_bps
                                       * ops.RENDER_WARPS)))
            args += [rows, -(-total // (ops.RENDER_WARPS * rows))]
        return lambda: lib.pong_render_launch(*args, stream())

    def grayscale(lib, src):
        args = [src.data_ptr(), gray.data_ptr(), npx]
        if lib.gray_bps is not None:
            args += [1, max(1, min(-(-npx // (ops.GRAY_THREADS
                                              * ops.GRAY_VECTOR_PIXELS)),
                                   sms * lib.gray_bps))]
        return lambda: lib.grayscale_launch(*args, stream())

    res = {}
    for name, lib in libs.items():
        rgb.zero_()
        gray.zero_()
        errs = (render(lib)(), grayscale(lib, img)())
        torch.cuda.synchronize()
        ok = (errs == (0, 0) and torch.equal(rgb, want_rgb),
              torch.equal(gray, want_gray))
        print(json.dumps({"variant": name, "render_bitwise": ok[0],
                          "grayscale_bitwise": ok[1]}), flush=True)
        if not all(ok):
            raise SystemExit(f"image_ab: {name} != the plain version")
        res[name] = {"render_ms": [], "grayscale_ms": [],
                     "render_then_grayscale_ms": []}
    for name in list(libs) + list(libs)[::-1]:
        lib, r = libs[name], res[name]
        r["render_ms"].append(chip_smoke.time_ms(render(lib), reps=20))
        r["grayscale_ms"].append(
            chip_smoke.time_ms(grayscale(lib, img), reps=20))
        both = (render(lib), grayscale(lib, rgb))
        r["render_then_grayscale_ms"].append(chip_smoke.time_ms(
            lambda: (both[0](), both[1]()), reps=20))
    for name, r in res.items():
        print(json.dumps({"variant": name, **r}))
    screens = torch.empty(want_rgb.numel(), dtype=torch.uint8, device=dev)
    print(json.dumps({"memset_103.2MB_ms": [
        chip_smoke.time_ms(screens.zero_, reps=20) for _ in range(2)]}))
    print(chip_smoke.card_line())


def pool_runs() -> list:
    return [("Ant-v3", 4096, None, "fifo", ("env_step",), None),
            ("Ant-v3", 4096, 2048, "fifo", ("env_step",), None),
            ("PongClassic-v5", 1024, None, "fifo",
             ("pong_render", "grayscale", "resize"), None)]


if __name__ == "__main__":
    main(__doc__, texts, run, pool_runs)
