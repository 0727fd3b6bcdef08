"""Plain PyTorch flash attention (``repro/kernels/flash_attention/
ref.py``): masked GQA attention with f32 scores and softmax."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import default_scale

NEG_INF = -1e30
# the most a bf16 output may lie beyond bf16's rounding of the exact
# (f32) value, in units of its row's RMS: see ``rounding_excess``
BF16_EXCESS_TOL = 2e-3


def mha_reference(
    q: torch.Tensor,        # (B, H, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Skv, D)
    v: torch.Tensor,        # (B, Hkv, Skv, D)
    causal: bool = True,
    window: int = 0,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Sq, D) in q's dtype.  Query head ``h`` reads kv head
    ``h // G`` (G = H / Hkv); query ``i`` sits at position
    ``i + Skv - Sq`` (the ends are aligned); ``causal`` keeps keys at or
    before it, ``window`` > 0 the ``window`` newest of those.  Scores
    are scaled by ``sm_scale`` (default ``1 / sqrt(D)`` in f32).

    One deliberate difference from ``repro``'s ``mha_reference``: a
    row that sees no key returns 0, as the TPU kernel does (it re-masks
    the probabilities and divides by ``max(l, 1e-30)``); ``repro``'s
    softmax over all-masked scores returns the mean of V there.  The
    model path never builds such a row."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = default_scale(D) if sm_scale is None else sm_scale
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    o = torch.where(mask.any(dim=-1)[:, None], o, 0.0)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def rounding_excess(out: torch.Tensor, exact: torch.Tensor) -> float:
    """How far ``out`` lies beyond the rounding of ``exact`` (the f32
    value, ``mha_reference`` on f32 copies of the inputs) to ``out``'s
    dtype: the largest ``(|out - exact| - u * |exact|) / rms`` over all
    elements, where ``u`` is the dtype's unit roundoff (2^-8 for bf16)
    and ``rms`` the root mean square of ``exact`` over the element's
    row (head dim).  A kernel whose only error is the final rounding
    reads <= 0.  An absolute tolerance cannot tell a kernel that rounds
    its probabilities to bf16 before P.V: its outputs still differ from
    the plain version's by one ulp, as a correct kernel's do where the
    rounding falls the other way; this reads 6e-3 to 9e-3 for it
    (tests/test_torch_flash_attention.py), a split P.V 1e-5 or less."""
    u = torch.finfo(out.dtype).eps / 2
    exact = exact.float()
    rms = exact.pow(2).mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    err = (out.float() - exact).abs() - u * exact.abs()
    return float((err / rms).max()) if err.numel() else 0.0


__all__ = ["BF16_EXCESS_TOL", "NEG_INF", "mha_reference", "rounding_excess"]
