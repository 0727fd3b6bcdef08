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

On ``meta`` tensors (the dry run's) ``auto`` takes the kernel's
stand-in, ``torch.ops.repro_torch.decode_attention``: the launch's
checks, the kernel's one allocation (the output), and 4 D FLOPs a
(query head, position) pair for ``torch.utils.flop_counter``, over all T
positions, since the lengths hold no values there.

``split_plan`` picks how the kernel splits T over the warps of its block
per (kv head, lane), and ``load_width`` how wide its copies of K and V
into shared memory are; both are plain functions of shapes and
addresses, tested on the CPU.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.backend import (
    check_launch,
    count_launch,
    launch,
    resolve_backend,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
    default_scale,
)

# what csrc/decode_attention.cu instantiates
MAX_GROUP = 16      # query heads per kv head
MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 16          # positions a warp stages and computes at a time
MAX_WARPS = 8       # warps of a block


def _pow2_at_least(x: int) -> int:
    return 1 << (max(1, x) - 1).bit_length()


def _pow2_at_most(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def resident_rows(sms: int, smem_per_sm: int, row_bytes: int) -> int:
    """Rows of K and V the card stages at once: its shared memory over
    the bytes of one staged position (a K and a V row in each of a warp's
    two stages).  An estimate for ``split_plan``: the kernel pads rows
    and keeps q and the warps' partials beside them, and clamps a chunk
    to what one block can hold."""
    return sms * smem_per_sm // (4 * row_bytes)


@functools.lru_cache(maxsize=None)
def _device_rows(device: torch.device, row_bytes: int) -> int:
    props = torch.cuda.get_device_properties(device)
    return resident_rows(props.multi_processor_count,
                         props.shared_memory_per_multiprocessor, row_bytes)


def split_plan(B: int, Hkv: int, T: int, resident: int
               ) -> tuple[int, int]:
    """``(warps, rows)``: the warps of the kernel's block per (kv head,
    lane) and the positions of a chunk.  A lane's chunks ``[c * rows, (c
    + 1) * rows)`` below its length are dealt out in turn to the warps:
    chunk c to warp ``c % warps``.  So a short lane spreads over the
    warps as a long one does (the lengths live on the card; the plan sees
    only T), and a long T gives each warp more chunks.  As many warps as
    there are chunks, up to ``MAX_WARPS``, while the grid's staged rows
    all fit on the card at once (the B * Hkv blocks share ``resident``
    rows, from ``resident_rows``); chunks of ``CHUNK`` rows, or half that
    where a block would get one warp for several chunks and half gives it
    more (the LM collect's 1024 blocks)."""
    def plan(rows: int) -> tuple[int, int, int]:
        chunks = max(1, -(-T // rows))
        fit = _pow2_at_most(resident // rows // max(1, B * Hkv))
        return min(MAX_WARPS, _pow2_at_least(chunks), fit), rows, chunks

    warps, rows, chunks = plan(CHUNK)
    if warps == 1 and chunks > 1:
        half = plan(CHUNK // 2)
        if half[0] > 1:
            warps, rows = half[:2]
    return warps, rows


def load_width(k: torch.Tensor, v: torch.Tensor) -> int:
    """Bytes per copy of K and V into shared memory: the widest of 16, 8
    and 4 that divides both base addresses, every stride in bytes and a
    row's bytes (D * element size); else the element size (2 for bf16,
    which takes 2-byte loads)."""
    es = k.element_size()
    sizes = [k.data_ptr(), v.data_ptr(), k.shape[3] * es]
    sizes += [s * es for s in k.stride()[:3] + v.stride()[:3]]
    for w in (16, 8, 4):
        if all(x % w == 0 for x in sizes):
            return w
    return es


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
    if q.is_meta:
        return torch.ops.repro_torch.decode_attention(q, k, v, lengths)
    from repro_torch.kernels.build import library

    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    warps, rows = split_plan(
        B, Hkv, T, _device_rows(q.device, D * q.element_size()))
    err = launch(
        q, library().decode_attention_launch,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), default_scale(D),
        DTYPES[q.dtype], warps, rows, load_width(k, v))
    check_launch("decode_attention", err)
    count_launch(decode_attention)
    return out


@torch.library.custom_op(
    "repro_torch::decode_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor lengths) -> Tensor")
def _stand_in(q, k, v, lengths):
    raise RuntimeError("decode_attention's stand-in takes meta tensors only")


@_stand_in.register_fake
def _(q, k, v, lengths):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _stand_in_flops(q_shape, k_shape, v_shape, lengths_shape, *args,
                    **kwargs) -> int:
    """4 D FLOPs a (query head, position) pair over all T positions."""
    B, H, D = q_shape
    return 4 * B * H * D * k_shape[2]


decode_attention.launches = 0

__all__ = ["decode_attention", "decode_attention_reference", "load_width",
           "resident_rows", "split_plan"]
