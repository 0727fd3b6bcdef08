"""Kernel backend selection — the rule, stated once for every family.

  * ``"auto"``      — the hand-written CUDA kernel for CUDA tensors, the
    plain PyTorch version (``ref.py``) for CPU tensors;
  * ``"cuda"``      — the kernel; CPU tensors raise;
  * ``"reference"`` — the plain version on any device (for comparing a
    kernel with it on the card).

There is no fallback: a CUDA tensor under ``auto`` gets the kernel or an
exception, never the plain version.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "reference")


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"reference"`` for an op whose input is ``x``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; known: {BACKENDS}")
    if backend == "auto":
        return "cuda" if x.is_cuda else "reference"
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; got "
                         f"{x.device}")
    return backend


def check_launch(name: str, err: int) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


__all__ = ["BACKENDS", "check_launch", "resolve_backend"]
