"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(``repro/configs/dbrx_132b.py``).
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.common import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, head_dim=128,
        mlp_type="swiglu", norm_type="rmsnorm", rope_theta=500_000.0,
        moe=MoEConfig(num_experts=16, top_k=4),
    )
