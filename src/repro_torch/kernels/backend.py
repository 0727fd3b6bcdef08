"""Kernel backend selection — the rule, stated once for every family.

  * ``"auto"``      — the hand-written CUDA kernel for CUDA tensors, the
    plain PyTorch version (``ref.py``) for CPU tensors, and for ``meta``
    tensors (which hold no data: the dry run's, ``launch/dryrun.py``)
    the kernel's allocation stand-in where the kernel has one (the
    attention kernels: an op that allocates what the kernel allocates
    and counts the FLOPs the kernel does), else the plain version;
  * ``"cuda"``      — the kernel; other tensors raise;
  * ``"reference"`` — the plain version on any device (for comparing a
    kernel with it on the card).

There is no fallback: a CUDA tensor under ``auto`` gets the kernel or an
exception, never the plain version, and only a meta tensor gets the
stand-in.
"""

from __future__ import annotations

import threading

import torch

BACKENDS = ("auto", "cuda", "reference")


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """``"cuda"``, ``"reference"`` or, for a meta ``x`` under ``"auto"``,
    ``"meta"`` (an op without a stand-in runs its plain version there),
    for an op whose input is ``x``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; known: {BACKENDS}")
    if backend == "auto":
        if x.is_cuda:
            return "cuda"
        return "meta" if x.is_meta else "reference"
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; got "
                         f"{x.device}")
    return backend


def launch(x: torch.Tensor, entry, *args) -> int:
    """``entry(*args, stream)`` with ``x``'s card current and ``stream``
    that card's current stream; returns the entry's error code.  The
    ``ctypes`` entry points launch onto the current device, so a launch
    for a tensor on another card than the current one must switch to
    it first."""
    with torch.cuda.device(x.device):
        return entry(*args, torch.cuda.current_stream(x.device).cuda_stream)


def check_launch(name: str, err: int) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


_COUNT_LOCK = threading.Lock()


def count_launch(op) -> None:
    """``op.launches += 1`` under one lock: the bare ``+=`` reads, adds
    and writes back, and loses counts when host engine workers launch
    from several threads at once."""
    with _COUNT_LOCK:
        op.launches += 1


def reset_launches(ops) -> None:
    """Set each op's ``launches`` to 0 under ``count_launch``'s lock."""
    with _COUNT_LOCK:
        for op in ops:
            op.launches = 0


def kernel_ops() -> dict:
    """Every kernel's wrapper, by kernel name; each counts the launches
    of its kernel in this process in ``.launches``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.env_step.ops import env_multi_step
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.image import ops as img

    return {"env_step": env_multi_step, "pong_render": img.pong_render,
            "grayscale": img.grayscale, "crop": img.crop,
            "resize": img.resize, "decode_attention": decode_attention,
            "flash_attention": flash_attention}


def launch_counts() -> dict[str, int]:
    """``kernel_ops()``'s launch counts, read under the counters' lock."""
    ops = kernel_ops()
    with _COUNT_LOCK:
        return {k: op.launches for k, op in ops.items()}


__all__ = ["BACKENDS", "check_launch", "count_launch", "kernel_ops",
           "launch", "launch_counts", "reset_launches", "resolve_backend"]
