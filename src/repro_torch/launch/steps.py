"""The train and serving steps (``repro/launch/steps.py``): the train
step with its optimizer, the prefill and decode steps of a ``Model``,
their layouts over a mesh, and a synthetic batch for a shape cell.

``repro``'s steps are pure functions for ``jax.jit``; here they run
eagerly.  The train step takes the gradient with ``torch.autograd.grad``
over fresh leaves that share the parameters' storage, so no ``.grad``
is left on the state between steps, and returns a new state without
writing into the one it was given.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` named like
``repro``'s, e.g. ``launch/mesh.py::make_debug_mesh``) and a rule set,
the steps are ``repro``'s model-parallel steps: the train state is laid
out by ``train_state_shardings``, the batch by ``batch_shardings`` and
a cache by ``cache_shardings``, each leaf a DTensor, as ``repro``'s
``jax.jit`` places its arguments by ``in_shardings``; plain tensors
given to a step are placed on the way in (each rank must then hold the
same full values).  The model's shard points redistribute as
``with_sharding_constraint`` constrains.  Plain tensors that the model
forms itself (masks, positions, the rotary tables, the learning rate)
meet the DTensors as replicated ones (DTensor's implicit replication).
Gradients are reduced to the parameters' placements before the update,
and the updated state is put back on its plan (under ``ZERO1_RULES``
the update runs on the optimizer state's data shards and the new
parameters are gathered).  Next tokens and metrics come back whole, as
plain tensors on the rank's device; caches and states stay DTensors.
Every family runs on a mesh: the decoder stacks (dense, MoE, hybrid,
vlm), the xLSTM and Whisper.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import (
    BASELINE_RULES,
    RuleSet,
    Spec,
    make_shard_fn,
    opt_state_shardings,
    param_shardings,
    place,
    placements,
    resolve,
)
from repro_torch.models.api import Model, ShapeSpec
from repro_torch.models.common import ShardFn, is_dtensor, no_shard
from repro_torch.optim.adamw import Optimizer
from repro_torch.utils.tree import (
    tree_dataclass,
    tree_leaves,
    tree_map,
    tree_map_with_path,
)


@tree_dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor      # () int32


# --------------------------------------------------------------------- #
# logical axes of the trees that are not parameters
# --------------------------------------------------------------------- #
_BATCH_LOGICAL: dict[str, tuple[str | None, ...]] = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "frames": ("batch", "enc_seq", "embed"),
    "patch_embeds": ("batch", None, "embed"),
    "positions": ("batch", "seq", None),
}


def _shape(v: Any) -> tuple[int, ...]:
    """A tensor's shape, or the shape of ``Model.input_specs``' (shape,
    dtype) pair."""
    return tuple(v.shape) if isinstance(v, torch.Tensor) else tuple(v[0])


def batch_shardings(mesh: Any, specs: dict[str, Any], rules: RuleSet
                    ) -> dict[str, Spec]:
    """The spec of every model input, from ``Model.input_specs`` or a
    batch of tensors."""
    out = {}
    for k, v in specs.items():
        shape = _shape(v)
        names = _BATCH_LOGICAL.get(k, (None,) * len(shape))
        out[k] = resolve(mesh, shape, names, rules)
    return out


def cache_logical(path: str, leaf: torch.Tensor) -> tuple[str | None, ...]:
    """The logical axes of a cache leaf, from its path: the KV rows, the
    int8 scales, Whisper's cross K/V, the hybrid's SSM state, the
    xLSTM's recurrent states."""
    keys = path.split(".") if path else []
    last = keys[-1] if keys else ""
    if last in ("k", "v") and leaf.ndim == 5:
        return ("layers", "batch", "kv_seq", "kv_heads", None)
    if last in ("k_scale", "v_scale") and leaf.ndim == 4:
        return ("layers", "batch", "kv_seq", "kv_heads")
    if last in ("xk", "xv") and leaf.ndim == 5:
        return ("layers", "batch", "enc_seq", "kv_heads", None)
    if last == "ssm_h":
        return ("layers", "batch", "mlp", None)
    if last == "ssm_tail":
        return ("layers", "batch", None, "mlp")
    if "states" in keys:
        if leaf.ndim == 4:
            return ("batch", "heads", None, None)
        if leaf.ndim == 3:
            return ("batch", "heads", None)
        if leaf.ndim == 2:
            return ("batch", None)
    return (None,) * leaf.ndim


def cache_shardings(mesh: Any, cache_shape: Any, rules: RuleSet) -> Any:
    """The spec of every leaf of a cache (tensors or meta tensors)."""
    return tree_map_with_path(
        lambda path, leaf: () if leaf.ndim == 0 else resolve(
            mesh, tuple(leaf.shape), cache_logical(path, leaf), rules),
        cache_shape)


def sharded_cache(cache_shape: Any, mesh: Any, rules: RuleSet,
                  device: torch.device | str | None = None) -> Any:
    """A zero cache of ``cache_shape``'s shapes and dtypes (meta tensors)
    laid out by ``cache_shardings``, each rank allocating only its
    shard, on ``device`` (default the mesh's; the dry run's ``meta``
    allocates nothing)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    dev = torch.device(device if device is not None else mesh.device_type)

    def one(leaf: torch.Tensor, spec: Spec) -> torch.Tensor:
        want = placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(leaf.shape, mesh,
                                                         want)
        return DTensor.from_local(
            torch.zeros(local, dtype=leaf.dtype, device=dev), mesh, want,
            run_check=False, shape=leaf.shape, stride=leaf.stride())

    return tree_map(one, cache_shape,
                    cache_shardings(mesh, cache_shape, rules))


def train_state_shardings(mesh: Any, state_shape: TrainState,
                          rules: RuleSet) -> TrainState:
    """The train state's plan: the parameters by the rules, the
    optimizer state alike (or, under ``ZERO1_RULES``, over ``data`` on
    each leaf's largest divisible dim), the step replicated."""
    if rules.name == "zero1":
        opt = opt_state_shardings(mesh, state_shape.opt)
    else:
        opt = param_shardings(mesh, state_shape.opt, rules)
    return TrainState(params=param_shardings(mesh, state_shape.params,
                                             rules),
                      opt=opt, step=())


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor."""
    return x.full_tensor() if is_dtensor(x) else x


def _mesh_scope(mesh: Any):
    """Where plain tensors meet DTensors as replicated ones."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# --------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------- #
def loss_and_grads(model: Model, params: Any, batch: dict[str, Any],
                   microbatches: int = 1, shard: ShardFn = no_shard
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``model.train_loss`` at ``params``,
    grads in the parameters' structure.  With ``microbatches`` > 1 the
    batch is cut into that many contiguous slices of its leading dim,
    each slice's gradients are summed in f32 and the sums divided by the
    count, and the loss averaged alike (``metrics``: ``xent`` the mean
    loss, ``aux`` included, and ``aux`` reported as zero, as ``repro``
    reports them; the MoE loss stays in the loss and its gradients).
    With one microbatch ``metrics`` are the model's ``xent`` and
    ``aux``.  Under a mesh (``shard``) the loss is made whole before its
    gradient, and each microbatch's slice is laid out on the batch's
    plan again."""
    def one(mb_batch):
        with torch.enable_grad():
            leaves = tree_leaves(params)
            fresh = [p.detach().requires_grad_() for p in leaves]
            it = iter(fresh)
            loss, metrics = model.train_loss(
                tree_map(lambda _: next(it), params), mb_batch, shard=shard)
            if is_dtensor(loss):
                from torch.distributed.tensor import Replicate

                mesh = loss.device_mesh
                loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
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
            loss, _, grads = one({
                k: shard(v[i * mb:(i + 1) * mb],
                         _BATCH_LOGICAL.get(k, (None,) * v.ndim))
                for k, v in batch.items()})
            gsum = [s + g for s, g in zip(gsum, grads)]
            lsum = lsum + loss
        grads = [s / microbatches for s in gsum]
        loss = lsum / microbatches
        metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def make_train_step(model: Model, optimizer: Optimizer, lr_fn: Callable,
                    mesh: Any = None, rules: RuleSet = BASELINE_RULES,
                    microbatches: int = 1) -> Callable:
    """``train_step(state, batch) -> (new state, metrics)``: the gradient
    of ``model.train_loss`` (``loss_and_grads``), then ``optimizer``'s
    update at ``lr_fn(state.step)``; ``metrics`` are ``xent``, ``aux``,
    ``loss`` and ``lr``, 0-dim tensors on the model's device (reading
    one waits for the step).  With a ``mesh``, the model-parallel step
    under ``rules`` (the module's docstring)."""
    shard = make_shard_fn(mesh, rules)

    def train_step(state: TrainState, batch: dict[str, Any]):
        if mesh is not None:
            plan = train_state_shardings(mesh, state, rules)
            state = place(state, plan, mesh)
            batch = place(batch, batch_shardings(mesh, batch, rules), mesh)
        with _mesh_scope(mesh):
            loss, metrics, grads = loss_and_grads(
                model, state.params, batch, microbatches, shard)
            if mesh is not None:
                grads = place(grads, plan.params, mesh)
            lr = lr_fn(state.step)
            with torch.no_grad():
                params, opt = optimizer.update(grads, state.opt,
                                               state.params, lr)
            new = TrainState(params=params, opt=opt, step=state.step + 1)
            if mesh is not None:
                new = place(new, plan, mesh)
        metrics = {k: _whole(v) for k, v in
                   dict(metrics, loss=loss, lr=lr).items()}
        return new, metrics

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
def make_prefill_step(model: Model, seq_len: int, mesh: Any = None,
                      rules: RuleSet = BASELINE_RULES) -> Callable:
    """``prefill_step(params, batch) -> (next_token (B,) int32, cache)``
    with a cache of ``seq_len`` positions, the next token greedy; with a
    ``mesh``, the parameters, batch and cache laid out by their
    plans."""
    shard = make_shard_fn(mesh, rules)

    def prefill_step(params, batch):
        if mesh is not None:
            params = place(params, param_shardings(mesh, params, rules),
                           mesh)
            batch = place(batch, batch_shardings(mesh, batch, rules), mesh)
        with _mesh_scope(mesh):
            logits_last, cache = model.prefill(params, batch,
                                               max_len=seq_len, shard=shard)
            next_tok = logits_last.argmax(dim=-1).to(torch.int32)
        return _whole(next_tok), cache

    return prefill_step


def make_serve_step(model: Model, mesh: Any = None,
                    rules: RuleSet = BASELINE_RULES) -> Callable:
    """``serve_step(params, cache, batch) -> (next_token (B,) int32,
    cache)``: one greedy token per sequence against the cache; with a
    ``mesh``, every argument laid out by its plan."""
    shard = make_shard_fn(mesh, rules)

    def serve_step(params, cache, batch):
        if mesh is not None:
            params = place(params, param_shardings(mesh, params, rules),
                           mesh)
            cache = place(cache, cache_shardings(mesh, cache, rules), mesh)
            batch = place(batch, batch_shardings(mesh, batch, rules), mesh)
        with _mesh_scope(mesh):
            logits, cache = model.decode_step(
                params, batch["tokens"], cache,
                positions=batch.get("positions"), shard=shard)
            next_tok = logits.argmax(dim=-1).to(torch.int32)
        return _whole(next_tok), cache

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


__all__ = ["TrainState", "batch_shardings", "cache_logical",
           "cache_shardings", "init_train_state", "loss_and_grads",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "sharded_cache", "synth_batch", "train_state_shapes",
           "train_state_shardings"]
