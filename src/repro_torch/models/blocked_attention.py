"""Blocked attention of the model's prefill and train step
(``repro/models/blocked_attention.py``), on the flash-attention kernel.

``repro`` computes these two functions in jnp as the XLA analogue of
its Pallas flash kernel, so that the whole (B, H, S, S) score tensor is
never formed and the masked-out tiles are not computed:

  * ``banded_attention`` — sliding-window layers: each query sees its
    ``window`` newest keys, itself included;
  * ``online_causal_attention`` — full-causal layers.

Here both are one call of ``kernels/flash_attention/ops.py::
flash_attention`` on (B, H, S, D) views of the (B, S, H, D)
projections: the kernel takes their strides, so no input is copied, and
it skips the tiles outside the band as ``repro``'s loops do.  The TPU
tiling arguments (``block_q``, ``block_k``) are dropped: the kernel
picks its own tiles.  ``online_causal_attention`` takes ``repro``'s
``differentiable`` and runs the same kernel either way: under autograd
the kernel call carries its own backward (``kernels/flash_attention/
ops.py::_FlashAttentionFn``), where ``repro`` has to swap its
early-exit loop for a fixed-trip scan to be differentiable.

Under a mesh q, k and v are DTensors (``launch/steps.py``).  The kernel
then runs on each rank's local tensors (``_on_local_heads``): q keeps
its batch and head shards and is made whole along the sequence, K and
V keep the batch shard and are whole otherwise (``kv_heads`` maps to no
mesh axis in any rule set), and each rank hands the kernel its query
heads with the K/V heads of their own GQA group, a strided view of the
local K/V.  The output is a DTensor laid out as q; its gradient takes
the same route back.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import is_dtensor


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> a (B, H, S, D) view, no copy."""
    return x.transpose(1, 2)


def _on_local_heads(fn: Callable, q, k, v):
    """``fn(q, k, v)`` over (B, S, H, D) DTensors, run by each rank on
    its own batch rows and query heads.  The rank's K/V heads are those
    of its query heads' groups, ``h // (H / Hkv)``: a slice of the local
    K/V when the rank's heads cover whole groups or lie in one group,
    else (heads straddling groups) one K/V head gathered per query
    head."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = q.device_mesh
    qp = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in q.placements]
    kvp = [p if p == Shard(0) else Replicate() for p in qp]
    q, k, v = (q.redistribute(mesh, qp), k.redistribute(mesh, kvp),
               v.redistribute(mesh, kvp))
    # a rank reads only its own groups' K/V heads: their gradient is a
    # partial sum over the mesh dims that shard the query heads
    kv_grad = [Partial() if p == Shard(2) else r for p, r in zip(qp, kvp)]
    ql = q.to_local()
    kl, vl = (x.to_local(grad_placements=kv_grad) for x in (k, v))
    H, Hkv = q.shape[2], k.shape[2]
    group = H // Hkv
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    h0, hl = offset[2], ql.shape[2]
    first, last = h0 // group, (h0 + hl - 1) // group
    if h0 % group == 0 and hl % group == 0 or first == last:
        kl, vl = kl[:, :, first:last + 1], vl[:, :, first:last + 1]
    else:
        idx = torch.arange(h0, h0 + hl, device=kl.device) // group
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    return DTensor.from_local(fn(ql, kl, vl), mesh, qp, run_check=False)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, sm_scale: float | None = None
                     ) -> torch.Tensor:
    """Causal sliding-window attention over (B, S, Hq, D) queries and
    (B, S, Hkv, D) keys and values -> (B, S, Hq, D) in q's dtype."""
    if is_dtensor(q):
        return _on_local_heads(lambda *qkv: banded_attention(
            *qkv, window, sm_scale), q, k, v)
    out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                          causal=True, window=window, sm_scale=sm_scale)
    return out.transpose(1, 2)


def online_causal_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sm_scale: float | None = None,
                            differentiable: bool = False) -> torch.Tensor:
    """Full causal attention over (B, S, Hq, D) queries and (B, S, Hkv,
    D) keys and values -> (B, S, Hq, D) in q's dtype.  Differentiable
    whatever ``differentiable`` says."""
    del differentiable
    if is_dtensor(q):
        return _on_local_heads(lambda *qkv: online_causal_attention(
            *qkv, sm_scale), q, k, v)
    out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                          causal=True, sm_scale=sm_scale)
    return out.transpose(1, 2)


__all__ = ["banded_attention", "online_causal_attention"]
