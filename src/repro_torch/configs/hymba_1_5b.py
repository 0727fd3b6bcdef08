"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer,
sliding-window attention with 3 global layers, ssm_state 16.
Meta-tokens omitted, as in ``repro/configs/hymba_1_5b.py``.
[arXiv:2411.13676; hf]"""
from repro_torch.models.common import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64,
        mlp_type="swiglu", norm_type="rmsnorm", rope_theta=10_000.0,
        attn_type="sliding", window=1024, global_attn_layers=(0, 15, 31),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=1, chunk=256),
    )
