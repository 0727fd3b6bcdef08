#!/usr/bin/env python3
"""Compare block sizes and variants of the physics kernel
(``src/repro_torch/csrc/env_step.cu``) and the crop kernel
(``src/repro_torch/csrc/image.cu``) on one CUDA card, and the pools'
device time of two checkouts.

    python3 scripts/env_crop_ab.py make DIR [REF]   # where git is
    python3 scripts/env_crop_ab.py run DIR          # on the card
    python3 scripts/env_crop_ab.py pools DIR        # on the card

``make`` writes into DIR the working tree's ``env_step.cu`` and
``image.cu`` (``env_current.cu``, ``img_current.cu``), the files at git
revision REF (default HEAD: ``env_parent.cu``, ``img_parent.cu``), and
variants of the current ones, each a text patch of it: ``env_t64`` and
``env_t256`` (the physics in blocks of 64 and 256 threads, not 128);
``img_u4`` (four crop loads in flight a thread, not two), ``img_t256``
(crop blocks of 256 threads) and ``img_bulk`` (path (a) by bulk copies:
one block an image, its run brought into shared memory by
``cp.async.bulk`` and stored by another).  It also unpacks the checkout
at REF into ``DIR/parent_tree`` for ``pools``.

``run`` builds every ``DIR/*.cu`` into a library of its own (registers
and spills of the two kernels are printed), holds each variant bitwise
against the plain versions at chip_smoke.py's inputs, and times each
with ``chip_smoke.time_ms`` in turns A, B, ..., B, A: the parent's
physics (a thread a lane) and the current one (a lane on 8 threads) in
each block size, at the sync (4096) and async (2048) Ant lanes, and the
current one with every lane running 0, 1 and 9 substeps (the fixed cost
and the cost a substep); the parent's crop, the current one forced onto
each of its four paths, and the variants, on the Pong window of 1024
grayscale screens, with the library call
``x[:, 34:194, 0:160].contiguous()`` beside them; and one-element
``add_``, what a launch costs.

``pools`` runs the device time per recv (chip_smoke.py's ``drive_pool``
profile) of Ant-v3 N=4096 sync and M=2048 async and PongClassic-v5
N=1024 sync with the playfield cropped, from ``DIR/parent_tree`` and
from this checkout, each in its own process, in turns parent, current,
current, parent.  Both print JSON lines and the card's name and power
limit.  What is not particular to these kernels lives in
``ab_common.py``.
"""

from __future__ import annotations

import json
import sys

from ab_common import I, P, ROOT, build, const, main, patch, source

ENV_THREADS = "constexpr int kThreads = {};"
UNROLL = "constexpr int kCropUnroll = {};"
THREADS = "constexpr int kCropThreads = {};"
RUN_LAUNCH = """  if (path == kCropRuns)   // one row of height * width bytes an image
    launch_crop<uint4>(img, out, n, 1, in_h * in_w, 0, top * in_w, 1,
                       (int)run, s);"""
BULK_LAUNCH = """  if (path == kCropRuns)
    crop_bulk_kernel<<<n, 32, height * width, s>>>(
        (const uint8_t*)img, (uint8_t*)out, (long long)in_h * in_w,
        top * in_w, height * width);"""
BULK_KERNEL = """// one image's run a block: thread 0 brings it into shared
// memory by one bulk copy and stores it by another
__global__ void crop_bulk_kernel(const uint8_t* __restrict__ in,
                                 uint8_t* __restrict__ out,
                                 long long in_image, int offset, int run) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const uint32_t b = smem_u32(&bar), s = smem_u32(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" :: "r"(b)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  bulk_load(s, in + blockIdx.x * in_image + offset, run, b);
  bar_wait(b, 0);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
      :: "l"(out + (long long)blockIdx.x * run), "r"(s), "r"(run)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
}

}  // namespace
"""
ENV_LANES = (4096, 2048)
ENV_SUBSTEPS = (0, 1, 9)
CROP_PATHS = ("runs", "spans", "words", "bytes")


def texts(ref: str) -> dict[str, str]:
    env, img = source("env_step.cu"), source("image.cu")
    threads = const(env, ENV_THREADS)
    unroll, crop_threads = const(img, UNROLL), const(img, THREADS)
    other = 4 if unroll == 2 else 2
    out = {"env_parent": source("env_step.cu", ref), "env_current": env,
           "img_parent": source("image.cu", ref), "img_current": img,
           f"img_u{other}": patch(img, UNROLL.format(unroll),
                                  UNROLL.format(other)),
           "img_t256": patch(img, THREADS.format(crop_threads),
                             THREADS.format(256)),
           "img_bulk": patch(patch(img, RUN_LAUNCH, BULK_LAUNCH),
                             "}  // namespace\n", BULK_KERNEL)}
    for t in (64, 128, 256):
        if t != threads:
            out[f"env_t{t}"] = patch(env, ENV_THREADS.format(threads),
                                     ENV_THREADS.format(t))
    return out


def bind(name: str, text: str, lib) -> None:
    if name.startswith("env"):   # the parent takes no blocks
        planned = "int n_sub, int blocks" in text
        lib.env_step_launch.argtypes = (
            (P,) * 6 + (I, I) + ((I, P) if planned else (P,)))
        lib.threads = const(text, ENV_THREADS) if planned else None
    else:                        # the parent takes no path
        planned = "int width, int path" in text
        lib.crop_launch.argtypes = (
            (P, P) + (I,) * 7 + ((I, P) if planned else (P,)))


def run(out: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.env_step.ops import ENV_GROUP, env_multi_step
    from repro_torch.kernels.image.ops import CROP_RUNS

    libs = build(out, "env_step|crop", bind)
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    # the physics at chip_smoke.py's inputs, at both Ant cells' lanes,
    # then the current kernel at 4096 lanes with every lane running 0, 1
    # and 9 substeps: the fixed cost and the cost a substep
    calls, res = {}, {}
    inputs = {n: chip_smoke.env_inputs(
        n, np.random.default_rng(chip_smoke.SEED + (n != 4096)), dev)
        for n in ENV_LANES}
    cases = ([(n, 9, True) for n in ENV_LANES]
             + [(4096, k, False) for k in ENV_SUBSTEPS])
    env_names = sorted(n for n in libs if n.startswith("env"))
    for n, n_sub, with_cost in cases:
        s, a, c, r0 = inputs[n]
        c = c if with_cost else None
        want = env_multi_step(s, a, c, r0, n_sub=n_sub, backend="reference")
        o, r = torch.empty_like(s), torch.empty_like(r0)
        ptrs = [None if x is None else x.data_ptr()
                for x in (s, a, c, r0, o, r)]
        names = (env_names if with_cost
                 else [f"env_current_nsub{n_sub}"])
        for name in names:
            lib = libs[name.split("_nsub")[0]]
            plan = (() if lib.threads is None
                    else (-(-n * ENV_GROUP // lib.threads),))
            call = (lambda lib=lib, plan=plan, ptrs=ptrs, n=n, k=n_sub:
                    lib.env_step_launch(*ptrs, n, k, *plan, stream()))
            o.zero_()
            ok = call() == 0
            torch.cuda.synchronize()
            ok = ok and torch.equal(o, want[0]) and torch.equal(r, want[1])
            print(json.dumps({"variant": name, "lanes": n,
                              "bitwise": ok}), flush=True)
            if not ok:
                raise SystemExit(f"env_crop_ab: {name} != the plain version")
            calls[(name, n)] = call
            res[(name, n)] = []

    # crop of 1024 grayscale screens to the Pong window
    gray = torch.from_numpy(rng.integers(0, 256, (1024, 210, 160),
                                         dtype=np.uint8)).to(dev)
    top, left, ch, cw = chip_smoke.PONG_CROP
    want = gray[:, top:top + ch, left:left + cw].contiguous()
    crop = torch.empty_like(want)
    args = [gray.data_ptr(), crop.data_ptr(), 1024, 210, 160, top, left, ch,
            cw]
    plans = {"img_parent": ("img_parent", ())}
    for path, label in enumerate(CROP_PATHS):
        plans[f"img_{label}"] = ("img_current", (path,))
    for name in sorted(n for n in libs if n.startswith("img_")
                       and n not in ("img_parent", "img_current")):
        plans[name] = (name, (CROP_RUNS,))
    for name, (lib_name, plan) in plans.items():
        call = (lambda lib=libs[lib_name], plan=plan:
                lib.crop_launch(*args, *plan, stream()))
        crop.zero_()
        ok = call() == 0
        torch.cuda.synchronize()
        ok = ok and torch.equal(crop, want)
        print(json.dumps({"variant": name, "bitwise": ok}), flush=True)
        if not ok:
            raise SystemExit(f"env_crop_ab: {name} != the plain version")
        calls[(name, 1024)] = call
        res[(name, 1024)] = []
    one = torch.zeros(1, device=dev)
    calls[("launch_floor", 1)] = lambda: one.add_(1.0)
    calls[("crop_library", 1024)] = (
        lambda: gray[:, top:top + ch, left:left + cw].contiguous())
    res[("launch_floor", 1)], res[("crop_library", 1024)] = [], []

    order = list(calls)
    for key in order + order[::-1]:
        res[key].append(chip_smoke.time_ms(calls[key], reps=50))
    for (name, n), ms in res.items():
        print(json.dumps({"variant": name, "n": n, "ms": ms}))
    print(chip_smoke.card_line())


def pool_runs() -> list:
    import repro_torch

    cropped = [repro_torch.Grayscale(), repro_torch.Crop(34, 0, 160, 160),
               repro_torch.Resize(84, 84), repro_torch.FrameStack(4),
               repro_torch.RewardClip()]
    return [("Ant-v3", 4096, None, "fifo", ("env_step",), None),
            ("Ant-v3", 4096, 2048, "fifo", ("env_step",), None),
            ("PongClassic-v5", 1024, None, "fifo",
             ("pong_render", "grayscale", "crop", "resize"), cropped)]


if __name__ == "__main__":
    main(__doc__, texts, run, pool_runs)
