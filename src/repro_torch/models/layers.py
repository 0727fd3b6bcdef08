"""Transformer layers of the dense decoder (``repro/models/layers.py``):
norms, RoPE, GQA attention without a cache, MLPs.

Plain functions over parameter dicts, in the JAX package's layout and
with its casts: every weight is cast to the compute dtype at use, norms
and softmax run in float32 and cast back.  Only the dense, full-causal,
no-cache branch of ``attention`` is ported; the sliding-window, blocked,
int8-cache and cached-prefill branches wait (ROADMAP A).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def norm_init(cfg: ModelConfig, device, lead: tuple[int, ...] = ()
              ) -> dict[str, torch.Tensor]:
    shape = lead + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=cfg.param_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(p: dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of q/k (qwen3)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    half = cfg.hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)


def rope_tables(positions: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of the rotary angles at ``positions`` (B, S), each
    (B, S, 1, hd / 2) f32.  They depend on positions only, so a forward
    forms them once and every layer's q and k reuse them: XLA shares
    them between layers by common-subexpression elimination, eager
    PyTorch would recompute them for each of the 2 * n_layers calls."""
    angles = positions.float()[..., None] * rope_freqs(cfg, positions.device)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables: tuple[torch.Tensor, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, D) rotated by ``rope_tables(positions, cfg)``."""
    cos, sin = tables
    half = cfg.hd // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, cfg: ModelConfig, device,
              lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d, pd = cfg.d_model, cfg.param_dtype
    p = {
        "wq": dense_init(gen, d, cfg.q_dim, pd, device, lead),
        "wk": dense_init(gen, d, cfg.kv_dim, pd, device, lead),
        "wv": dense_init(gen, d, cfg.kv_dim, pd, device, lead),
        "wo": dense_init(gen, cfg.q_dim, d, pd, device, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (cfg.hd,), dtype=pd, device=device)
        p["k_norm"] = torch.ones(lead + (cfg.hd,), dtype=pd, device=device)
    return p


def causal_mask(S: int, T: int, offset: int = 0, device=None
                ) -> torch.Tensor:
    """(1, 1, S, T) causal mask; query i attends keys j <= i + offset."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor | None, cfg: ModelConfig) -> torch.Tensor:
    """Masked GQA attention, f32 softmax.  q: (B, S, Hq, D), k/v:
    (B, T, Hkv, D) -> (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).reshape(B, Hq, S, T)
    scores = scores.float() / math.sqrt(float(cfg.hd))
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w.reshape(B, Hkv, G, S, T), v)
    return o.reshape(B, S, Hq, D)


def attention(p: dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Full causal GQA self-attention over ``x`` (B, S, d), no cache;
    ``rope`` is ``rope_tables`` of the positions."""
    B, S, _ = x.shape
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    q = apply_rope(q, rope, cfg)
    k = apply_rope(k, rope, cfg)
    out = mha(q, k, v, causal_mask(S, S, device=x.device), cfg)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(cd)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_type == "swiglu":
        return {
            "wi": dense_init(gen, d, ff, pd, device, lead),
            "wg": dense_init(gen, d, ff, pd, device, lead),
            "wo": dense_init(gen, ff, d, pd, device, lead),
        }
    return {
        "wi": dense_init(gen, d, ff, pd, device, lead),
        "wo": dense_init(gen, ff, d, pd, device, lead),
    }


def apply_mlp(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"].to(cd)) * (x @ p["wi"].to(cd))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"].to(cd), approximate="tanh")
    return h @ p["wo"].to(cd)


__all__ = [
    "apply_mlp", "apply_norm", "apply_rope", "attention", "attn_init",
    "causal_mask", "mha", "mlp_init", "norm_init", "rms_head_norm",
    "rope_freqs", "rope_tables",
]
