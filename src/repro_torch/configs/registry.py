"""Architecture registry (``repro/configs/registry.py``), every arch of
the JAX package: ``get_config(arch)`` and the reduced same-family
``get_smoke_config(arch)`` for CPU tests."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    dbrx_132b,
    granite_moe_3b,
    hymba_1_5b,
    qwen2_vl_72b,
    qwen3_0_6b,
    whisper_large_v3,
    xlstm_125m,
)
from repro_torch.models.common import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
)


def _qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        qk_norm=True, mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=1_000_000.0,
    )


def _llama3_2_3b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128,
        mlp_type="swiglu", norm_type="rmsnorm", rope_theta=500_000.0,
    )


def _starcoder2_3b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, head_dim=128,
        mlp_type="gelu", norm_type="layernorm", rope_theta=100_000.0,
    )


ARCHS = {
    "qwen3-14b": _qwen3_14b,
    "llama3.2-3b": _llama3_2_3b,
    "starcoder2-3b": _starcoder2_3b,
    "qwen3-0.6b": qwen3_0_6b.get_config,
    "hymba-1.5b": hymba_1_5b.get_config,
    "dbrx-132b": dbrx_132b.get_config,
    "granite-moe-3b-a800m": granite_moe_3b.get_config,
    "whisper-large-v3": whisper_large_v3.get_config,
    "qwen2-vl-72b": qwen2_vl_72b.get_config,
    "xlstm-125m": xlstm_125m.get_config,
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    cfg = ARCHS[arch]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU tests: 2 layers, d_model 64,
    4 query and 2 kv heads of width 16, vocab 512, max_seq 256, window
    32, 4 experts top-2, an SSM of state 4 in chunks of 8; an xLSTM of
    an mLSTM and an sLSTM layer in chunks of 8 over 4 heads; a 2-layer
    encoder over 16 frames with 4 kv heads; M-RoPE sections (2, 3, 3)
    (as ``repro``'s)."""
    cfg = get_config(arch)
    kw: dict = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, head_dim=16, max_seq=256, window=32,
        global_attn_layers=(0,) if cfg.global_attn_layers else ())
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=4, conv_width=4, expand=1, chunk=8)
    if cfg.xlstm is not None:
        kw.update(xlstm=XLSTMConfig(slstm_every=2, slstm_offset=1, chunk=8),
                  n_kv_heads=4, d_ff=0)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, enc_seq=16, n_kv_heads=4)  # whisper is MHA
    if cfg.rope_type == "mrope":
        kw["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs"]
