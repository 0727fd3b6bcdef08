"""The train and serving steps (``repro/launch/steps.py``): the train
step with its optimizer, the prefill and decode steps of a ``Model``,
and a synthetic batch for a shape cell.

Only the single-device form is ported: ``mesh=None``.  A mesh (the
model-parallel steps of ``repro``) raises and names ROADMAP A19.

``repro``'s steps are pure functions for ``jax.jit``; here they run
eagerly.  The train step takes the gradient with ``torch.autograd.grad``
over fresh leaves that share the parameters' storage, so no ``.grad``
is left on the state between steps, and returns a new state without
writing into the one it was given.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.api import Model, ShapeSpec
from repro_torch.optim.adamw import Optimizer
from repro_torch.utils.tree import tree_dataclass, tree_leaves, tree_map


@tree_dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor      # () int32


def _single_device(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded steps are not ported: pass mesh=None (ROADMAP A19)")


# --------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------- #
def loss_and_grads(model: Model, params: Any, batch: dict[str, Any],
                   microbatches: int = 1
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``model.train_loss`` at ``params``,
    grads in the parameters' structure.  With ``microbatches`` > 1 the
    batch is cut into that many contiguous slices of its leading dim,
    each slice's gradients are summed in f32 and the sums divided by the
    count, and the loss averaged alike (``metrics``: ``xent`` the mean
    loss, ``aux`` included, and ``aux`` reported as zero, as ``repro``
    reports them; the MoE loss stays in the loss and its gradients).
    With one microbatch ``metrics`` are the model's ``xent`` and
    ``aux``."""
    def one(mb_batch):
        with torch.enable_grad():
            leaves = tree_leaves(params)
            fresh = [p.detach().requires_grad_() for p in leaves]
            it = iter(fresh)
            loss, metrics = model.train_loss(
                tree_map(lambda _: next(it), params), mb_batch)
            grads = torch.autograd.grad(loss, fresh, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    if microbatches == 1:
        loss, metrics, grads = one(batch)
    else:
        mb = next(iter(batch.values())).shape[0] // microbatches
        gsum = [torch.zeros_like(p, dtype=torch.float32)
                for p in tree_leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
        for i in range(microbatches):
            loss, _, grads = one({k: v[i * mb:(i + 1) * mb]
                                  for k, v in batch.items()})
            gsum = [s + g for s, g in zip(gsum, grads)]
            lsum = lsum + loss
        grads = [s / microbatches for s in gsum]
        loss = lsum / microbatches
        metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def make_train_step(model: Model, optimizer: Optimizer, lr_fn: Callable,
                    mesh: Any = None, microbatches: int = 1) -> Callable:
    """``train_step(state, batch) -> (new state, metrics)``: the gradient
    of ``model.train_loss`` (``loss_and_grads``), then ``optimizer``'s
    update at ``lr_fn(state.step)``; ``metrics`` are ``xent``, ``aux``,
    ``loss`` and ``lr``, 0-dim tensors on the model's device (reading
    one waits for the step)."""
    _single_device(mesh)

    def train_step(state: TrainState, batch: dict[str, Any]):
        loss, metrics, grads = loss_and_grads(model, state.params, batch,
                                              microbatches)
        lr = lr_fn(state.step)
        with torch.no_grad():
            params, opt = optimizer.update(grads, state.opt, state.params, lr)
        metrics = dict(metrics, loss=loss, lr=lr)
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step


def init_train_state(model: Model, optimizer: Optimizer,
                     gen: torch.Generator) -> TrainState:
    """Step 0: ``model.init(gen)``, the optimizer's state of it, and a
    0-dim int32 step counter, all on the model's device."""
    params = model.init(gen)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_shapes(model: Model, optimizer: Optimizer) -> TrainState:
    """The train state's structure, shapes and dtypes, as tensors on the
    ``meta`` device: nothing is allocated or drawn."""
    meta = Model(model.cfg, "meta")
    return init_train_state(meta, optimizer, torch.Generator())


# --------------------------------------------------------------------- #
# serve steps
# --------------------------------------------------------------------- #
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
    """Every model input of ``shape``, drawn from ``gen`` on its device,
    input by input in name order, by ``repro``'s rules: ``tokens`` and
    ``labels`` uniform in ``[0, vocab)``, other int inputs (the M-RoPE
    ``positions``) in ``[0, 4)``, float inputs (frames, patch
    embeddings) normals x 0.02 in their dtype."""
    batch = {}
    for name, (shp, dtype) in sorted(model.input_specs(shape).items()):
        if dtype.is_floating_point:
            batch[name] = torch.randn(shp, generator=gen, dtype=dtype,
                                      device=gen.device) * 0.02
        else:
            hi = model.cfg.vocab if name in ("tokens", "labels") else 4
            batch[name] = torch.randint(0, hi, shp, generator=gen,
                                        dtype=dtype, device=gen.device)
    return batch


__all__ = ["TrainState", "init_train_state", "loss_and_grads",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "synth_batch", "train_state_shapes"]
