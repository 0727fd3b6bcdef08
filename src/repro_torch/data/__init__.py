from repro_torch.data.pipeline import (
    BatchSpec,
    BinTokenSource,
    SyntheticSource,
    write_bin_tokens,
)

__all__ = ["BatchSpec", "BinTokenSource", "SyntheticSource",
           "write_bin_tokens"]
