"""qwen2-vl-72b [vlm] — M-RoPE (t/h/w sections); the dynamic-resolution
vision frontend is a stub (``input_specs`` supplies patch embeddings),
as in ``repro/configs/qwen2_vl_72b.py``.  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=1_000_000.0, rope_type="mrope", mrope_sections=(16, 24, 24),
        frontend="vision",
    )
