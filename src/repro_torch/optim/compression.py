"""Gradient compression with error feedback (``repro/optim/compression.py``).

int8 block quantisation of a gradient tree: each leaf is cut into blocks
of ``BLOCK`` values (the last one zero-padded), each block gets the scale
``max|x| / 127 + 1e-12`` and codes ``round(x / scale)`` (half to even)
clipped to +-127.  The quantisation residual ``g + e - deq`` is carried in
an error-feedback buffer, so the compressed sum tracks the true one over
steps (1-bit-Adam style).  It is a standalone utility, as in the JAX
package: no driver or train step calls it.

Everything runs on the leaves' device.  The divisions take their divisor
as a tensor on that device: PyTorch's CUDA ``div`` turns a Python-scalar
divisor into a multiply by its reciprocal, one bit off true division, so
with a tensor divisor the card's codes, scales and errors equal the
CPU's (and the JAX package's) bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_map

BLOCK = 256


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    top = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = blocks.abs().amax(dim=1, keepdim=True) / top + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape: torch.Size,
                  size: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:size].reshape(shape)


def _compress(g: torch.Tensor, e: torch.Tensor | None = None
              ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    gf = g.to(torch.float32)
    if e is not None:
        gf = gf + e
    q, s = _quant_int8(gf)
    return (q, s), gf - _dequant_int8(q, s, gf.shape, gf.numel())


def compress_tree(grads: Any, error: Any | None) -> tuple[Any, Any]:
    """Quantise every leaf of ``grads`` plus its ``error`` (None: no
    feedback).  Returns ``(qtree, new_error)``: ``qtree`` has ``grads``'
    structure with a ``(codes (blocks, BLOCK) int8, scales (blocks, 1)
    f32)`` pair at each leaf."""
    if error is None:
        pairs = tree_map(_compress, grads)
    else:
        pairs = tree_map(_compress, grads, error)
    return (tree_map(lambda g, p: p[0], grads, pairs),
            tree_map(lambda g, p: p[1], grads, pairs))


def decompress_tree(qtree: Any, like: Any) -> Any:
    """The f32 values of ``qtree`` in the shapes of ``like``'s leaves."""
    return tree_map(lambda g, qs: _dequant_int8(qs[0], qs[1], g.shape,
                                                g.numel()), like, qtree)


def init_error(params: Any) -> Any:
    """A zero f32 error buffer for every leaf, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


__all__ = ["BLOCK", "compress_tree", "decompress_tree", "init_error"]
