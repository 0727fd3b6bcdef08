"""granite-moe-3b-a800m [moe] — 40 experts top-8, fine-grained d_ff 512
(``repro/configs/granite_moe_3b.py``).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.common import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        mlp_type="swiglu", norm_type="rmsnorm", rope_theta=10_000.0,
        moe=MoEConfig(num_experts=40, top_k=8),
        tie_embeddings=True,
    )
