"""Public wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``).

CUDA tensors launch the kernel, CPU tensors run the plain version
(``ref.py``); ``backend="reference"`` forces the plain version on the
card.  ``flash_attention.launches`` counts kernel launches and nothing
else.

q, k and v may be strided views: ``models/blocked_attention.py`` passes
the (B, S, H, D) projections transposed to (B, H, S, D).  The kernel
takes the batch, head and sequence strides of all four tensors, so the
main path copies no input; only the head dim must be dense.  The bf16
kernel loads through TMA, which needs a 16-byte aligned base and
strides of whole 16 bytes (``tma_compatible``): a bf16 input that
fails it is first copied into a fresh dense tensor, and
``flash_attention.copies`` counts those copies (the f32 kernel loads
with plain loads and takes any such view).  The output has q's layout
(``torch.empty_like``), so the transposed view comes back as a dense
(B, S, H, D) tensor.

Under autograd (grad enabled and q, k or v requiring grad) the kernel
runs inside ``_FlashAttentionFn``: its forward is the same launch, and
its backward recomputes the function with the plain version on the
saved inputs and differentiates that (``plain_grads``), as ``repro``
takes the gradient of its blocked attention by autodiff of plain jnp.
There is no backward kernel; the backward launches nothing.

On ``meta`` tensors (the dry run's, ``launch/dryrun.py``) ``auto``
takes the kernel's stand-in, ``torch.ops.repro_torch.flash_attention``:
it checks what the launch checks and allocates what the kernel
allocates (the output, and a bf16 input's copy where TMA could not load
it), and ``torch.utils.flop_counter`` counts it at the FLOPs the kernel
does, 4 D per visible (query, key) pair (``visible_pairs``: the pairs
of the K tiles ``tile_plan`` visits that the masks keep), where the
plain version forms every score.  Under autograd the stand-in runs in
``_FlashAttentionFn`` as the launch does, and the backward is the
card's own, ``plain_grads`` in its chunks.

``tile_plan`` is the K-tile plan that the bf16 kernel computes for
each query tile, in Python so that the CPU tests can hold it against a
brute-force mask.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.backend import (
    check_launch,
    count_launch,
    launch,
    resolve_backend,
)
from repro_torch.kernels.decode_attention.ref import default_scale
from repro_torch.kernels.flash_attention.ref import mha_reference

# what csrc/flash_attention.cu instantiates
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tma_compatible(t: torch.Tensor) -> bool:
    """Whether TMA can load ``t`` (B, H, S, D) as it lies: a dense head
    dim, a 16-byte aligned base, and every other stride a whole number
    of 16 bytes (the stride of a dimension of extent 1 is never used)."""
    el = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all((t.stride(i) * el) % 16 == 0 for i in range(3)
                    if t.shape[i] > 1))


def tile_plan(Sq: int, Skv: int, causal: bool, window: int, bq: int,
              bk: int) -> list[tuple[int, int, tuple[bool, ...]]]:
    """For each tile of ``bq`` query rows, ``(lo, hi, masked)``: the K
    tiles of ``bk`` keys ``[lo, hi)`` that its rows can see (the others
    are skipped), and for each of them whether it needs a per-element
    mask (it crosses the causal diagonal, a window edge or the ragged
    end ``Skv``) or lies wholly inside the band.  Query row ``i`` sits
    at position ``i + Skv - Sq``.  ``csrc/flash_attention.cu``'s bf16
    kernel computes the same formulas (``tile_range``,
    ``tile_unmasked``) with ``bq`` 128 for a block and 64 for each of
    its consumers, ``bk`` 128."""
    off = Skv - Sq
    n_kt = -(-Skv // bk)
    plan = []
    for r0 in range(0, Sq, bq):
        r1 = min(r0 + bq, Sq)
        first, last = r0 + off, r1 - 1 + off        # positions
        hi = n_kt
        if causal:
            hi = 0 if last < 0 else min(n_kt, last // bk + 1)
        lo = 0
        if window > 0:
            lo = 0 if first - window + 1 <= 0 else (first - window + 1) // bk
        lo = min(lo, hi)
        masked = tuple(
            not ((kt + 1) * bk <= Skv
                 and (not causal or (kt + 1) * bk - 1 <= first)
                 and (window == 0 or kt * bk > last - window))
            for kt in range(lo, hi))
        plan.append((lo, hi, masked))
    return plan


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks keep: the kernel's work for
    these shapes.  Query row ``i`` sits at position ``i + Skv - Sq`` and
    sees keys ``[lo, hi)``: up to itself when causal, its ``window``
    newest when windowed."""
    # numpy: a dry run's dispatch modes would count torch's tensors here
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.clip(pos + 1, 0, Skv) if causal else np.full(Sq, Skv)
    lo = np.clip(pos - window + 1, 0, Skv) if window else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, backend: str = "auto"
                    ) -> torch.Tensor:
    """(B, H, Sq, D) x (B, Hkv, Skv, D) -> (B, H, Sq, D) in q's dtype:
    ``mha_reference``'s function (end-aligned query positions, causal
    and sliding-window masks, GQA by ``h // (H / Hkv)``, f32 softmax; a
    row that sees no key gives 0).  Differentiable in q, k and v."""
    B, H, Sq, D = q.shape
    _require(k.ndim == 4 and k.shape == v.shape and k.shape[0] == B
             and k.shape[3] == D and H % k.shape[1] == 0,
             f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")
    _require(window >= 0, f"flash_attention: window {window} < 0")
    if resolve_backend(backend, q) == "reference":
        return mha_reference(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, sm_scale)
    return _launch(q, k, v, causal, window, sm_scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, sm_scale: float | None) -> torch.Tensor:
    """The kernel's launch on CUDA tensors that ``flash_attention`` has
    checked for shape; its stand-in on meta tensors."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _require(q.dtype in DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"flash_attention: q, k, v must share f32 or bf16; got "
             f"{q.dtype}, {k.dtype}, {v.dtype}")
    _require(D in HEAD_DIMS,
             f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    _require(q.stride(3) == 1 and k.stride(3) == 1 and v.stride(3) == 1,
             "flash_attention: the head dim must be dense")
    _require(k.device == q.device and v.device == q.device,
             "flash_attention: all inputs must be on one device")
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    scale = default_scale(D) if sm_scale is None else float(sm_scale)
    if q.is_meta:
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                     scale)
    from repro_torch.kernels.build import library

    out = torch.empty_like(q)     # q's layout: its head dim is dense
    if out.numel() == 0:
        return out
    err = launch(
        q, library().flash_attention_launch,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, Sq, Skv, D, int(causal), int(window), scale,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        DTYPES[q.dtype])
    check_launch("flash_attention", err)
    count_launch(flash_attention)
    return out


# the most bytes of f32 scores that one step of ``plain_grads`` forms
BACKWARD_SCORE_BYTES = 1 << 30


def chunk_rows(B: int, H: int, Sq: int, Skv: int, causal: bool) -> int:
    """The query rows of one step of ``plain_grads``: all ``Sq`` unless
    causal (B, H, Sq, Skv) f32 scores exceed ``BACKWARD_SCORE_BYTES``."""
    if not causal:
        return Sq
    return max(1, min(Sq, BACKWARD_SCORE_BYTES // max(1, 4 * B * H * Skv)))


def plain_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dout: torch.Tensor, causal: bool, window: int,
                sm_scale: float | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``mha_reference(q, k, v)`` against the output
    gradient ``dout``, by autograd of the plain version.  When the
    (B, H, Sq, Skv) f32 scores exceed ``BACKWARD_SCORE_BYTES``, causal
    attention recomputes in chunks of query rows: rows ``[a, b)`` sit at
    positions ``a + Skv - Sq ...`` and see no key at or past ``b + Skv -
    Sq``, so the chunk runs against keys ``[0, b + Skv - Sq)``, which
    keeps ``mha_reference``'s end-aligned positions exact; dk and dv add
    up over the chunks.  Each chunk runs in f32 (``mha_reference`` takes
    its scores in f32 whatever the inputs), so dk and dv are rounded to
    the inputs' dtype once, after the sum, as autograd of the whole
    function rounds them."""
    B, H, Sq, _ = q.shape
    Skv = k.shape[2]
    off = Skv - Sq
    rows = chunk_rows(B, H, Sq, Skv, causal)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    with torch.enable_grad():
        for a in range(0, Sq, rows):
            b = min(a + rows, Sq)
            hi = min(Skv, b + off) if causal else Skv
            if hi <= 0:
                continue            # rows that see no key: output 0
            qc = q[:, :, a:b].detach().float().requires_grad_()
            kc = k[:, :, :hi].detach().float().requires_grad_()
            vc = v[:, :, :hi].detach().float().requires_grad_()
            out = mha_reference(qc, kc, vc, causal=causal, window=window,
                                sm_scale=sm_scale)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             dout[:, :, a:b].float())
            dq[:, :, a:b] = gq
            dk[:, :, :hi] += gk
            dv[:, :, :hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward with ``plain_grads`` for its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window, sm_scale)
        return _launch(q, k, v, causal, window, sm_scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            dq, dk, dv = plain_grads(q, k, v, dout, *ctx.masks)
        return dq, dk, dv, None, None, None


@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float sm_scale) -> Tensor")
def _stand_in(q, k, v, causal, window, sm_scale):
    raise RuntimeError("flash_attention's stand-in takes meta tensors only")


@_stand_in.register_fake
def _(q, k, v, causal, window, sm_scale):
    return torch.empty_like(q)     # the kernel's output, in q's layout


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _stand_in_flops(q_shape, k_shape, v_shape, causal, window, sm_scale,
                    *args, **kwargs) -> int:
    """4 D FLOPs a visible pair: q.k and p.v, a multiply and an add
    each."""
    B, H, Sq, D = q_shape
    return 4 * B * H * D * visible_pairs(Sq, k_shape[2], causal, window)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    if tma_compatible(t):
        return t
    flash_attention.copies += 1
    return t.clone(memory_format=torch.contiguous_format)


flash_attention.launches = 0
flash_attention.copies = 0

__all__ = ["BACKWARD_SCORE_BYTES", "chunk_rows", "flash_attention",
           "mha_reference", "plain_grads", "tile_plan", "tma_compatible",
           "visible_pairs"]
