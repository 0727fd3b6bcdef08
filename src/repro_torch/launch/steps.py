"""The serving steps (``repro/launch/steps.py``): the prefill and
decode steps of a ``Model``, and a synthetic batch for a shape cell.

Only the single-device form is ported: ``mesh=None``.  A mesh (the
model-parallel steps of ``repro``) raises and names ROADMAP A19; the
train step waits with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.api import Model, ShapeSpec


def _single_device(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded steps are not ported: pass mesh=None (ROADMAP A19)")


def make_prefill_step(model: Model, seq_len: int, mesh: Any = None
                      ) -> Callable:
    """``prefill_step(params, batch) -> (next_token (B,) int32, cache)``
    with a cache of ``seq_len`` positions, the next token greedy."""
    _single_device(mesh)

    def prefill_step(params, batch):
        logits_last, cache = model.prefill(params, batch, max_len=seq_len)
        return logits_last.argmax(dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(model: Model, mesh: Any = None) -> Callable:
    """``serve_step(params, cache, batch) -> (next_token (B,) int32,
    cache)``: one greedy token per sequence against the cache."""
    _single_device(mesh)

    def serve_step(params, cache, batch):
        logits, cache = model.decode_step(params, batch["tokens"], cache,
                                          positions=batch.get("positions"))
        return logits.argmax(dim=-1).to(torch.int32), cache

    return serve_step


def synth_batch(model: Model, shape: ShapeSpec, gen: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """Uniform tokens for ``shape``, drawn from ``gen`` on
    its device, input by input in name order."""
    batch = {}
    for name, (shp, dtype) in sorted(model.input_specs(shape).items()):
        batch[name] = torch.randint(0, model.cfg.vocab, shp, generator=gen,
                                    dtype=dtype, device=gen.device)
    return batch


__all__ = ["make_prefill_step", "make_serve_step", "synth_batch"]
