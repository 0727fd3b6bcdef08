"""llama3.2-3b [dense] — small llama3
(``repro/configs/llama3_2_3b.py``).
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128,
        mlp_type="swiglu", norm_type="rmsnorm", rope_theta=500_000.0,
    )
