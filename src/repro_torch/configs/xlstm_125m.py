"""xlstm-125m [ssm] — mLSTM + sLSTM blocks at the paper's [7:1] ratio;
O(1) recurrent state (runs long_500k).  As in
``repro/configs/xlstm_125m.py``.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.common import ModelConfig, XLSTMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        rope_type="none", tie_embeddings=True,
        xlstm=XLSTMConfig(slstm_every=8, slstm_offset=7, chunk=256),
    )
