"""Public wrapper of the decode-attention kernel
(``csrc/decode_attention.cu``).

CUDA tensors launch the kernel, CPU tensors run the plain version
(``ref.py``); ``backend="reference"`` forces the plain version on the
card.  ``decode_attention.launches`` counts kernel launches and nothing
else.

The cache may be a strided view: ``LMPolicy.decode_step`` passes layer
``i`` of a ``(B, n_layers, Hkv, T, D)`` cache, whose batch stride spans
every layer.  The kernel takes the batch, head and position strides of
q, k and v, so no call copies a cache; only the last dim must be dense.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import check_launch, resolve_backend
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
    default_scale,
)

# what csrc/decode_attention.cu instantiates
MAX_GROUP = 16      # query heads per kv head
MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, backend: str = "auto"
                     ) -> torch.Tensor:
    """(B, H, D) query vs (B, Hkv, T, D) cache -> (B, H, D) in q's dtype,
    over the first ``lengths[b]`` positions of each lane, scores scaled
    by ``1 / sqrt(D)``."""
    B, H, D = q.shape
    _require(k.ndim == 4 and k.shape == v.shape and k.shape[0] == B
             and k.shape[3] == D and H % k.shape[1] == 0,
             f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")
    if resolve_backend(backend, q) == "reference":
        return decode_attention_reference(q, k, v, lengths)
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    _require(q.dtype in DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"decode_attention: q, k, v must share f32 or bf16; got "
             f"{q.dtype}, {k.dtype}, {v.dtype}")
    _require(G <= MAX_GROUP and D <= MAX_HEAD_DIM,
             f"decode_attention: G={G} > {MAX_GROUP} or D={D} > "
             f"{MAX_HEAD_DIM}")
    _require(q.stride(2) == 1 and k.stride(3) == 1 and v.stride(3) == 1,
             "decode_attention: the head dim must be dense")
    _require(lengths.shape == (B,) and lengths.dtype == torch.int32
             and lengths.is_contiguous(),
             f"decode_attention: lengths must be a contiguous ({B},) "
             f"int32; got {tuple(lengths.shape)} {lengths.dtype}")
    _require(all(t.device == q.device for t in (k, v, lengths)),
             "decode_attention: all inputs must be on one device")
    from repro_torch.kernels.build import library

    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    err = library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), default_scale(D),
        DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

__all__ = ["decode_attention", "decode_attention_reference"]
