"""Model configuration and parameter initialisers
(``repro/models/common.py``), for every family of the JAX package:
dense, MoE (``moe``), hybrid attention + SSM (``hybrid``), xLSTM
(``ssm``), the Whisper encoder-decoder (``encdec``) and the M-RoPE
vision-language decoder (``vlm``).

``repro``'s execution fields ``scan_layers`` and ``use_pallas`` are
left out: they steer XLA tracing (one layer traced under ``lax.scan``,
Pallas against the XLA path), which eager PyTorch does not have.  Every
layer's attention window is a Python int here, exactly as in ``repro``
with ``scan_layers=False``.  ``remat`` is ``repro``'s: what a train
step keeps of each layer for its backward (``models/remat.py``).

Parameters are nested dicts of tensors in the JAX package's layout: the
decoder layers are stacked on a leading ``n_layers`` dim, so the
numpy leaves of a ``repro`` parameter pytree load as they are
(``rl/policy_lm.py::params_from_jax``).  The xLSTM keeps ``repro``'s
list of per-layer dicts (its layers are of two kinds); Whisper stacks
its encoder and decoder layers each on their own leading dim.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves

# ``shard(x, logical_names) -> x``: a model's shard point, where
# ``repro`` places ``with_sharding_constraint``
# (``distributed/sharding.py::make_shard_fn`` makes the mesh's)
ShardFn = Callable[[torch.Tensor, tuple[str | None, ...]], torch.Tensor]


def no_shard(x: torch.Tensor, names: tuple[str | None, ...]
             ) -> torch.Tensor:
    """The single-device shard point: ``x`` as it is, no op."""
    return x


def shard_mesh(shard: ShardFn) -> Any:
    """The ``DeviceMesh`` of a mesh's shard function, None for
    ``no_shard``."""
    return getattr(shard, "mesh", None)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (none exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM branch (hymba's parallel heads)."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 1          # d_inner = expand * d_model
    chunk: int = 256         # chunked scan for memory


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8     # xLSTM[7:1]
    slstm_offset: int = 7
    chunk: int = 256
    proj_factor: float = 2.0  # mLSTM up-projection


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``repro``'s ``ModelConfig`` that its models read,
    sliding-window and serving fields included."""

    name: str
    family: str              # dense | moe | hybrid | ssm | encdec | vlm
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
    rope_type: str = "standard"      # standard | mrope | none
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    attn_type: str = "full"          # full | sliding
    window: int = 1024
    global_attn_layers: tuple[int, ...] = ()   # these layers use full attn
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    enc_layers: int = 0              # encdec: encoder depth
    enc_seq: int = 1500              # stub frontend sequence (frames)
    frontend: str | None = None      # audio | vision (precomputed embeds)
    tie_embeddings: bool = False
    max_seq: int = 8192
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # execution
    remat: str = "full"              # none | full | dots (models/remat.py)
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

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode against a 500k context?  An SSM, or a
        hybrid whose attention is a sliding window."""
        if self.family == "ssm":
            return True
        return self.family == "hybrid" and self.attn_type == "sliding"

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
    """Model FLOPs a trained token, ``repro``'s 6 N convention: 2 for the
    forward and 4 for the backward of each multiply-accumulate with a
    weight (the q, k, v, o projections, the MLP or the ``top_k`` experts
    a token runs and the router, the SSM branch's projections, an
    encoder-decoder's encoder layers and cross-attention projections,
    the LM head); attention's own products are left out."""
    d, ff = cfg.d_model, cfg.d_ff
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * ff
    if cfg.moe is not None:
        mlp = mlp * cfg.moe.top_k + d * cfg.moe.num_experts  # router
    per_layer = attn_mlp = attn + mlp
    if cfg.ssm is not None:  # parallel SSM branch
        di = cfg.ssm.expand * d
        per_layer += 2 * d * di + di * d + di * cfg.ssm.state_dim * 3
    total = cfg.n_layers * per_layer
    if cfg.enc_layers:
        total += cfg.enc_layers * attn_mlp      # once per sequence
        total += cfg.n_layers * d * (cfg.q_dim + 2 * cfg.kv_dim)  # cross
    return 6.0 * (total + d * cfg.vocab)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShardFn", "XLSTMConfig",
           "count_params", "is_dtensor", "no_shard", "shard_mesh", "dense_init", "embed_init",
           "model_flops_per_token"]
