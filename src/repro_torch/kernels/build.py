"""Build the port's CUDA sources into one shared library at first use.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, then linked into one ``.so`` with a plain
C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source is never served a stale build.

Flags: ``sm_90a`` (Hopper) and no fast math for every source.  The env
step and image kernels are also built with ``-fmad=false``, so nvcc does
not contract ``a*b + c`` into fused multiply-adds: the physics and the
render are held bitwise to their plain PyTorch versions and must round
exactly as they do.  Decode and flash attention are held to a tolerance
(2e-2 in bf16; 1e-5 and 3e-5 in f32: ``chip_smoke.py``,
tests/test_torch_gpu.py), and a fused multiply-add rounds once where a
multiply and an add round twice, so they keep them (``SOURCE_FLAGS``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)
# sources built with other flags than NVCC_FLAGS
SOURCE_FLAGS = {"flash_attention.cu": BASE_FLAGS,
                "decode_attention.cu": BASE_FLAGS}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry point -> argument types (pointers and the stream as c_void_p;
# a count that can pass 2^31, and strides, as c_longlong)
SIGNATURES = {
    # state, action, cost|NULL, reward0|NULL, out_state, out_reward,
    # n, n_sub, blocks, stream
    "env_step_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ball_x, ball_y, paddle_y, enemy_y, out, n, rows, blocks, stream
    "pong_render_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rgb, out, n_pixels, vec, blocks, stream
    "grayscale_launch": (_P, _P, _L, _I, _I, _P),
    # img, taps, out, n, h, w, out_h, out_w, ka, kb, bulk, stream
    "resize_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # img, out, n, in_h, in_w, top, left, height, width, path, stream
    "crop_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, lengths, out, B, H, Hkv, T, D, q/k/v strides (8), scale,
    # dtype, warps, rows, width, stream
    "decode_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _F, _I,
                                _I, _I, _I, _P),
    # q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, scale,
    # q/k/v/out strides (12), dtype, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _L, _L, _L, _I, _P),
}


def source_flags(src: Path) -> tuple[str, ...]:
    return SOURCE_FLAGS.get(src.name, NVCC_FLAGS)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(" ".join(source_flags(src)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out: Path) -> None:
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *source_flags(s), "-c", str(s), "-o",
                              str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(lib, out)


# one build serves every thread: without it, threads that reach their
# first kernel together would each miss the cache and run nvcc
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call (by one thread,
    however many call at once)."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(_nvcc(), sources, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "SIGNATURES", "SOURCE_FLAGS",
           "library", "source_flags"]
