"""Rematerialisation of a model's layers (``repro/models/transformer.py::
_remat``): what a train step keeps of each layer for its backward.

``ModelConfig.remat`` is ``repro``'s:

  * ``"none"`` — every layer keeps its activations for the backward;
  * ``"full"`` — a layer keeps its inputs only and runs again inside the
    backward (``jax.checkpoint``; here ``torch.utils.checkpoint`` without
    reentry);
  * ``"dots"`` — a layer keeps the outputs of its matmuls without batch
    dims and recomputes the rest (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``; here selective checkpointing
    that saves ``aten.mm`` and ``aten.addmm``, the products with a
    weight, and recomputes the attention's batched products and the
    flash kernel).

The recompute gives the same values as the forward, so the loss and
gradients are those of ``"none"`` bit for bit; it costs about one more
forward of the layer stack (``distributed/analytic.py``).  ``remat``
runs a layer so only where a gradient is taken: a layer that writes a
cache (the serve steps write theirs in place) or runs without grad runs
once, as it is.

The recompute runs inside the backward, which the autograd engine runs
under the thread-local state of its caller: DTensor's implicit
replication and the dispatch modes (the dry run's) that the train step
holds around its forward and its backward alike, so the recompute sees
what the forward saw.  Nothing is re-entered for it: a backward run
outside that scope fails at every ``remat``, ``none`` included (the
rotary tables, plain tensors, meet DTensor gradients in ops that are
not recomputed).  The flash kernel's forward saves q, k and v, which
the recompute forms again, so a checkpointed layer launches the kernel
a second time in the backward.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.models.common import ModelConfig
from repro_torch.utils.tree import tree_leaves

REMAT = ("none", "full", "dots")

# the products with a weight: (tokens, d_in) x (d_in, d_out), no batch dim
SAVED_OPS = frozenset((torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default))


def dots_policy(ctx, op, *args, **kwargs) -> _checkpoint.CheckpointPolicy:
    """``"dots"``: save what ``SAVED_OPS`` return, recompute the rest."""
    if op in SAVED_OPS:
        return _checkpoint.CheckpointPolicy.MUST_SAVE
    return _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    """``checkpoint``'s ``context_fn`` for ``"dots"``: selective
    checkpointing's caching and cached modes."""
    return _checkpoint.create_selective_checkpoint_contexts(dots_policy)


def remat_call(fn: Callable, cfg: ModelConfig, *args: Any) -> Any:
    """``fn(*args)``, one layer, its activations kept or recomputed as
    ``cfg.remat`` says; as it is with grad off, or when no tensor of
    ``args`` requires grad."""
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; known: {REMAT}")
    if cfg.remat == "none" or not torch.is_grad_enabled() or not any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in tree_leaves(args)):
        return fn(*args)
    if cfg.remat == "dots":
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      context_fn=_dots_contexts)
    return _checkpoint.checkpoint(fn, *args, use_reentrant=False)


__all__ = ["REMAT", "SAVED_OPS", "dots_policy", "remat_call"]
