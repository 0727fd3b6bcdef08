"""Blocked attention of the model's prefill and train step
(``repro/models/blocked_attention.py``), on the flash-attention kernel.

``repro`` computes these two functions in jnp as the XLA analogue of
its Pallas flash kernel, so that the whole (B, H, S, S) score tensor is
never formed and the masked-out tiles are not computed:

  * ``banded_attention`` — sliding-window layers: each query sees its
    ``window`` newest keys, itself included;
  * ``online_causal_attention`` — full-causal layers.

Here both are one call of ``kernels/flash_attention/ops.py::
flash_attention`` on (B, H, S, D) views of the (B, S, H, D)
projections: the kernel takes their strides, so no input is copied, and
it skips the tiles outside the band as ``repro``'s loops do.  The TPU
tiling arguments (``block_q``, ``block_k``) are dropped: the kernel
picks its own tiles.  ``online_causal_attention`` takes ``repro``'s
``differentiable`` and runs the same kernel either way: under autograd
the kernel call carries its own backward (``kernels/flash_attention/
ops.py::_FlashAttentionFn``), where ``repro`` has to swap its
early-exit loop for a fixed-trip scan to be differentiable.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> a (B, H, S, D) view, no copy."""
    return x.transpose(1, 2)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, sm_scale: float | None = None
                     ) -> torch.Tensor:
    """Causal sliding-window attention over (B, S, Hq, D) queries and
    (B, S, Hkv, D) keys and values -> (B, S, Hq, D) in q's dtype."""
    out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                          causal=True, window=window, sm_scale=sm_scale)
    return out.transpose(1, 2)


def online_causal_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sm_scale: float | None = None,
                            differentiable: bool = False) -> torch.Tensor:
    """Full causal attention over (B, S, Hq, D) queries and (B, S, Hkv,
    D) keys and values -> (B, S, Hq, D) in q's dtype.  Differentiable
    whatever ``differentiable`` says."""
    del differentiable
    out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                          causal=True, sm_scale=sm_scale)
    return out.transpose(1, 2)


__all__ = ["banded_attention", "online_causal_attention"]
