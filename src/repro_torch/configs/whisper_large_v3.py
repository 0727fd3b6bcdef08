"""whisper-large-v3 [audio] — encoder-decoder, MHA (kv = 20); the conv
frontend is a stub (``input_specs`` supplies (B, 1500, 1280) frame
embeddings), as in ``repro/configs/whisper_large_v3.py``.
[arXiv:2212.04356]"""
from repro_torch.models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, head_dim=64,
        mlp_type="gelu", norm_type="layernorm", rope_type="none",
        enc_layers=32, enc_seq=1500, frontend="audio",
        max_seq=32768 + 8,
    )
