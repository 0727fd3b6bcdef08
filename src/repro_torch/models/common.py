"""Model configuration and parameter initialisers
(``repro/models/common.py``), for the dense decoder family only.

``repro``'s execution fields ``scan_layers``, ``remat`` and
``use_pallas`` are left out: they steer XLA tracing (one layer traced
under ``lax.scan``, rematerialisation, Pallas against the XLA path),
which eager PyTorch does not have.  Every layer's attention window is a
Python int here, exactly as in ``repro`` with ``scan_layers=False``.

Parameters are nested dicts of tensors in the JAX package's layout: the
decoder layers are stacked on a leading ``n_layers`` dim, so the
numpy leaves of a ``repro`` parameter pytree load as they are
(``rl/policy_lm.py::params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``repro``'s ``ModelConfig`` that a dense decoder
    reads, sliding-window and serving fields included.  The MoE, SSM,
    xLSTM, encoder-decoder and RoPE-variant fields are not ported
    (ROADMAP A)."""

    name: str
    family: str              # dense only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 1_000_000.0
    attn_type: str = "full"          # full | sliding
    window: int = 1024
    global_attn_layers: tuple[int, ...] = ()   # these layers use full attn
    tie_embeddings: bool = False
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # execution
    windowed_cache: bool = False     # ring-buffer KV cache for sliding layers
    attn_impl: str = "dense"         # dense | blocked (flash_attention kernel)
    kv_cache_dtype: str = "bf16"     # bf16 | int8 (quantized KV cache)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device | str,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """``lead + (d_in, d_out)`` normals scaled by ``1/sqrt(d_in)``; a
    ``lead`` of ``(n_layers,)`` draws a stacked layer weight at once."""
    w = torch.randn(lead + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device: torch.device | str) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def count_params(params: Any) -> int:
    """Elements over every tensor leaf of ``params``."""
    return sum(p.numel() for p in tree_leaves(params))


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Model FLOPs a trained token, ``repro``'s 6 N convention for the
    dense family: 2 for the forward and 4 for the backward of each
    multiply-accumulate with a weight (the q, k, v, o projections, the
    MLP, the LM head); attention's own products are left out."""
    d, ff = cfg.d_model, cfg.d_ff
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * ff
    return 6.0 * (cfg.n_layers * (attn + mlp) + d * cfg.vocab)


__all__ = ["ModelConfig", "count_params", "dense_init", "embed_init",
           "model_flops_per_token"]
