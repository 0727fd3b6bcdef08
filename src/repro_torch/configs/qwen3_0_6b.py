"""qwen3-0.6b [dense] — qk_norm, GQA, head_dim 128 (widened q-proj),
tied embeddings (``repro/configs/qwen3_0_6b.py``)."""
from repro_torch.models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=1_000_000.0, tie_embeddings=True,
    )
