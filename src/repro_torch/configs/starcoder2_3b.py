"""starcoder2-3b [dense] — GQA, RoPE, non-gated GELU MLP, LayerNorm
(``repro/configs/starcoder2_3b.py``).
[arXiv:2402.19173; hf]"""
from repro_torch.models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, head_dim=128,
        mlp_type="gelu", norm_type="layernorm", rope_theta=100_000.0,
    )
