"""Plain PyTorch decode attention (``repro/kernels/decode_attention/
ref.py``): one query token per sequence against its KV cache."""

from __future__ import annotations

import numpy as np
import torch


def default_scale(d: int) -> float:
    """``1 / sqrt(D)`` rounded to float32, as the JAX package forms it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def decode_attention_reference(
    q: torch.Tensor,        # (B, H, D) — one new token per sequence
    k: torch.Tensor,        # (B, Hkv, T, D)
    v: torch.Tensor,        # (B, Hkv, T, D)
    lengths: torch.Tensor,  # (B,) valid cache lengths
) -> torch.Tensor:
    """(B, H, D) in q's dtype.  Query head ``h`` reads kv head
    ``h // G`` (G = H / Hkv); scores scaled by ``1 / sqrt(D)``; keys at
    positions ``>= lengths[b]`` are masked; softmax and sums in
    float32.  A lane of length 0 gives exactly 0 (every key masked; the
    kernel's guarded combine)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = default_scale(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    o = torch.where(lengths[:, None, None, None] > 0, o, 0.0)
    return o.reshape(B, H, D).to(q.dtype)


__all__ = ["decode_attention_reference", "default_scale"]
