#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card, and check what comes out.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the time to build the kernel library from
   ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, inputs made with numpy from a seed:
   bitwise (``torch.equal``) for all four.  Each kernel and its plain
   version are timed with CUDA events;
3. the pool, through ``repro_torch.make``: Ant-v3 N=4096 sync and
   N=4096/M=2048 async (fifo), PongClassic-v5 N=1024 sync and
   N=1024/M=512 async (sjf).  Each is warmed up, its kernels' launch
   counts are set to 0, then 200 recvs run with actions from a numpy seed
   routed by ``env_id``; every kernel of the path must have launched, and
   every async block must hold distinct ids.  Five more recvs run under
   ``torch.profiler`` for the device time per recv;
4. the card against the CPU: 20 recvs of PongClassic-v5 and Ant-v3 at
   N=16 (async M=8) from one key on ``cuda`` and on ``cpu``: ids, done,
   costs equal; Pong obs and reward bitwise, Ant's within 1e-4 (CUDA's
   ``cosf`` and torch's CPU ``cos`` differ by an ulp on some inputs).

Then a ``kernels`` JSON line, the card line, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing
any result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and f32 ops/s
# outside the tensor cores, used for the 32-bit integer work too
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of one Ant substep in csrc/env_step.cu, counting each
# cosf as one: legs 4 x 7 + contacts 4 + thrust 12 + normal 16
# + joints 8 x 11 + torso 1 + 9 + 7 + 3 + 2 + 9 + 6 + reward 2 + 15 + 2 + 3
ENV_STEP_OPS = 207


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, trials: int = 5) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps``
    back-to-back calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------- #
def check_kernels() -> dict[str, dict]:
    import torch

    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.image import ops as img_ops
    from repro_torch.kernels.image.ops import _band_weights

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    res = {}

    def row(name, src, replaces, out, plain, nbytes, ops, run, run_plain):
        err = max((float((a.float() - b.float()).abs().max())
                   if a.numel() else 0.0) for a, b in zip(out, plain))
        equal = all(torch.equal(a, b) for a, b in zip(out, plain))
        if not equal:
            raise AssertionError(f"{name}: kernel != plain version, max abs "
                                 f"err {err}")
        b_ms, b_by = bound(nbytes, ops)
        res[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(run), "plain_ms": time_ms(run_plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        log(f"  {name}: bitwise equal; kernel {res[name]['ms']:.4f} ms, "
            f"plain {res[name]['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")

    # env_step: Ant N = 4096, costs 5..9 (main path: state gathered from
    # the pool, n_sub = max_cost = 9)
    n = 4096
    state = np.zeros((n, 28), np.float32)
    state[:, 0:2] = rng.normal(0, 1, (n, 2))
    state[:, 2] = rng.uniform(0.15, 0.9, n)
    state[:, 3:12] = rng.normal(0, 0.3, (n, 9))
    state[:, 12:20] = rng.uniform(-1.2, 1.2, (n, 8))
    state[:, 20:28] = rng.normal(0, 1.0, (n, 8))
    s = torch.from_numpy(state).to(dev)
    a = torch.from_numpy(rng.uniform(-1.3, 1.3, (n, 8)).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.integers(5, 10, n).astype(np.int32)).to(dev)
    r0 = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)).to(dev)

    def run():
        return env_ops.env_multi_step(s, a, c, r0, n_sub=9)

    def run_plain():
        return env_ops.env_multi_step(s, a, c, r0, n_sub=9,
                                      backend="reference")

    row("env_step", "src/repro_torch/csrc/env_step.cu",
        "src/repro/kernels/env_step/kernel.py:103", run(), run_plain(),
        nbytes=n * (28 * 4 * 2 + 8 * 4 + 4 + 4 + 4),
        ops=ENV_STEP_OPS * float(c.sum()), run=run, run_plain=run_plain)

    # pong_render: PongClassic N = 1024 (sync block); ball positions
    # include whole and half grid values, where compares sit on an edge
    n = 1024
    pos = rng.uniform(0, 84, (4, n)).astype(np.float32)
    pos[:, : n // 4] = np.round(pos[:, : n // 4] * 2) / 2
    bx, by, py, ey = (torch.from_numpy(p).to(dev) for p in pos)
    rgb = img_ops.pong_render(bx, by, py, ey)

    def run():
        return img_ops.pong_render(bx, by, py, ey)

    def run_plain():
        return img_ops.pong_render(bx, by, py, ey, backend="reference")

    row("pong_render", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:167", [rgb], [run_plain()],
        nbytes=n * 16 + rgb.numel(), ops=rgb.numel() // 3 * 20.0,
        run=run, run_plain=run_plain)

    # grayscale: the main path feeds it the render; random bytes cover
    # every input value
    img = torch.from_numpy(rng.integers(0, 256, (n, 210, 160, 3),
                                        dtype=np.uint8)).to(dev)
    for x in (rgb, img):
        if not torch.equal(img_ops.grayscale(x),
                           img_ops.grayscale(x, backend="reference")):
            raise AssertionError("grayscale: kernel != plain version")

    def run():
        return img_ops.grayscale(img)

    def run_plain():
        return img_ops.grayscale(img, backend="reference")

    row("grayscale", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:63", [run()], [run_plain()],
        nbytes=img.numel() * 4 // 3, ops=img.numel() // 3 * 7.0,
        run=run, run_plain=run_plain)

    # resize: 210x160 -> 84x84 area (main path), plus bilinear and a size
    # that does not divide, checked but not timed
    gray = img_ops.grayscale(img)
    for h, w, oh, ow, method in ((210, 160, 84, 84, "bilinear"),
                                 (37, 29, 11, 17, "area")):
        x = gray[:64, :h, :w].contiguous()
        if not torch.equal(img_ops.resize(x, oh, ow, method),
                           img_ops.resize(x, oh, ow, method,
                                          backend="reference")):
            raise AssertionError(f"resize {h}x{w}->{oh}x{ow} {method}: "
                                 "kernel != plain version")

    def run():
        return img_ops.resize(gray, 84, 84)

    def run_plain():
        return img_ops.resize(gray, 84, 84, backend="reference")

    _, a_lo, a_hi = _band_weights(210, 84, "area", dev)
    _, b_lo, b_hi = _band_weights(160, 84, "area", dev)
    taps = 160 * float((a_hi - a_lo).sum()) + 84 * float((b_hi - b_lo).sum())
    row("resize", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:98", [run()], [run_plain()],
        nbytes=gray.numel() + n * 84 * 84, ops=n * 2 * taps,
        run=run, run_plain=run_plain)
    return res


# ---------------------------------------------------------------------- #
# phase 3: the pool on the card
# ---------------------------------------------------------------------- #
def counters() -> dict:
    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.image import ops as img_ops

    return {"env_step": env_ops.env_multi_step,
            "pong_render": img_ops.pong_render,
            "grayscale": img_ops.grayscale, "resize": img_ops.resize}


def action_tables(pool, count: int, rng) -> list:
    import torch

    act = pool.spec.act_spec
    shape = (count, pool.num_envs) + act.shape
    if act.dtype.is_floating_point:
        tabs = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    else:
        tabs = rng.integers(0, int(act.maximum) + 1, shape).astype(np.int32)
    return list(torch.from_numpy(tabs).to(pool.device))


def kernel_family(name: str) -> str:
    """A CUDA kernel's name without its template and argument lists,
    plus the op it applies where PyTorch names one (its functor or
    ``*_kernel_cuda``), e.g. ``vectorized_elementwise_kernel[BitwiseAnd
    Functor]``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    ops = re.findall(r"\w*Functor\w*|\w+_kernel_cuda", name)
    return f"{base}[{ops[-1]}]" if ops else base


def profile_recvs(pool, ps, ts, tables, recvs: int = 5) -> dict:
    """Device time of ``recvs`` more recvs under ``torch.profiler``: the
    sum of CUDA kernel durations per recv, kernels per recv, and the six
    kernel families with the most time.  All None when the profiler sees
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(recvs):
            ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()],
                               ts.env_id)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_busy_ms_per_recv": None, "kernels_per_recv": None,
                "top_kernels_ms_per_recv": None}
    by_family: dict[str, float] = {}
    for e in kernels:
        fam = kernel_family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_family.items(), key=lambda kv: -kv[1])[:6]
    return {
        "device_busy_ms_per_recv": sum(by_family.values()) / 1e3 / recvs,
        "kernels_per_recv": len(kernels) / recvs,
        "top_kernels_ms_per_recv": {k: v / 1e3 / recvs for k, v in top},
    }


def drive_pool(task: str, n: int, m: int | None, schedule: str,
               path: tuple[str, ...], recvs: int = 200) -> dict:
    import torch

    import repro_torch

    pool = repro_torch.make(task, num_envs=n, batch_size=m,
                            schedule=schedule)
    tables = action_tables(pool, 8, np.random.default_rng(SEED))
    ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
    for t in range(10):
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
    torch.cuda.synchronize()

    for fn in counters().values():
        fn.launches = 0
    ids, costs = [], []
    t0 = time.perf_counter()
    for t in range(recvs):
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
        ids.append(ts.env_id)
        costs.append(ts.step_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}

    for k in path:
        if launches[k] == 0:
            raise AssertionError(f"{task}: kernel {k} never launched")
    ids = torch.stack(ids)
    block = pool.batch_size
    srt = ids.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{task}: a block holds a repeated env_id")
    obs = ts.obs
    want = (block,) + pool.spec.obs_spec.shape
    if tuple(obs.shape) != want or obs.dtype != pool.spec.obs_spec.dtype:
        raise AssertionError(f"{task}: obs {tuple(obs.shape)} {obs.dtype}, "
                             f"want {want}")
    if obs.dtype.is_floating_point and not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"{task}: non-finite obs")
    steps = recvs * block
    frames = int(torch.stack(costs).sum())
    out = {"task": task, "num_envs": n, "batch_size": block,
           "schedule": schedule, "recvs": recvs, "seconds": dt,
           "env_steps_per_s": steps / dt, "frames_per_s": frames / dt,
           "ms_per_recv": dt / recvs * 1e3, "launches": launches}
    out.update(profile_recvs(pool, ps, ts, tables))
    busy = out["device_busy_ms_per_recv"]
    out["device_idle_share"] = (None if busy is None
                                else 1.0 - busy / out["ms_per_recv"])
    log(f"  {task} N={n} M={block} {schedule}: "
        f"{out['env_steps_per_s']:.0f} env steps/s, "
        f"{out['frames_per_s']:.0f} frames/s, "
        f"{out['ms_per_recv']:.2f} ms/recv, device busy {busy} ms/recv, "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------- #
# phase 4: the card against the CPU
# ---------------------------------------------------------------------- #
def cross_check(task: str, atol: float | None) -> None:
    import torch

    import repro_torch

    runs = {}
    for dev in ("cuda", "cpu"):
        pool = repro_torch.make(task, num_envs=16, batch_size=8,
                                device=dev, max_episode_steps=7)
        tables = [t.cpu() for t in action_tables(
            pool, 20, np.random.default_rng(SEED + 1))]
        ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
        rec = []
        for t in range(20):
            a = tables[t][ts.env_id.long().cpu()].to(dev)
            ps, ts = pool.step(ps, a, ts.env_id)
            rec.append({k: getattr(ts, k).cpu() for k in
                        ("env_id", "done", "step_cost", "reward", "obs")})
        runs[dev] = rec
    for t, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for k in ("env_id", "done", "step_cost"):
            if not torch.equal(g[k], c[k]):
                raise AssertionError(f"{task} recv {t}: {k} differs")
        for k in ("reward", "obs"):
            if atol is None:
                ok = torch.equal(g[k], c[k])
            else:
                ok = torch.allclose(g[k], c[k], rtol=0, atol=atol)
            if not ok:
                err = float((g[k].float() - c[k].float()).abs().max())
                raise AssertionError(f"{task} recv {t}: {k} differs, max "
                                     f"abs err {err}")
    log(f"  {task}: cuda == cpu over 20 recvs"
        + (" (bitwise)" if atol is None else f" (obs, reward within {atol})"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.kernels.build import library

    # the resize plain version needs true f32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    library()
    log(f"  kernel library built in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    kernels = check_kernels()

    log("phase 3: the pool on the card")
    ant = ("env_step",)
    pong = ("pong_render", "grayscale", "resize")
    runs = [
        drive_pool("Ant-v3", 4096, None, "fifo", ant),
        drive_pool("Ant-v3", 4096, 2048, "fifo", ant),
        drive_pool("PongClassic-v5", 1024, None, "fifo", pong),
        drive_pool("PongClassic-v5", 1024, 512, "sjf", pong),
    ]
    for r in runs:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v
    log(json.dumps({"pool_runs": runs}))

    log("phase 4: the card against the CPU")
    cross_check("PongClassic-v5", None)
    cross_check("Ant-v3", 1e-4)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
