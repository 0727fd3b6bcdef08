"""The model facade (``repro/models/api.py``) over every architecture
family: the dense, MoE, hybrid and vlm decoders
(``models/transformer.py``), the xLSTM (``ssm``, ``models/xlstm.py``)
and the Whisper encoder-decoder (``encdec``, ``models/whisper.py``).

``build_model(cfg)`` returns a ``Model`` with ``init``, ``train_loss``,
``init_cache``, ``prefill``, ``decode_step`` and ``input_specs``, so the
train and serving steps (``launch/steps.py``) never dispatch on the
family.  Shape cells pair an arch with ``train_4k``, ``prefill_32k``,
``decode_32k`` or ``long_500k``.

Differences from ``repro``, by design: ``init`` draws from a
``torch.Generator`` (to run ``repro``'s weights, load them with
``rl/policy_lm.py::params_from_jax``); caches are written in place
(``models/layers.py::attention``, ``models/whisper.py``), so a caller
must not reuse a cache it passed to ``decode_step``; ``prefill``
applies the LM head to the last position only, and a vlm's
``train_loss`` to the text region only, where ``repro`` slices the
full-sequence head's logits and XLA drops the rest (eager PyTorch would
compute all of it: 10 GB and 10 TFLOP at qwen3-0.6b, B=4, S=8192);
``softmax_xent`` forms the f32 copy of the logits again in the backward
(``torch.utils.checkpoint``), where XLA decides itself what to keep.

``train_loss``, ``prefill`` and ``decode_step`` take ``repro``'s
``shard`` (``launch/steps.py`` makes a mesh's) and hand it to every
family, as ``repro`` does.  Under a mesh a fresh cache is laid out by
``launch/steps.py::cache_shardings``, each rank allocating only its
shard, and the loss runs on each rank's block of the logits,
all-reducing along a sharded vocab (``softmax_xent``).  ``cache_specs``
is a decode cell's cache on the meta device (the dry run's,
``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import transformer, whisper, xlstm
from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    is_dtensor,
    no_shard,
    shard_mesh,
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# the stub vision frontend's patch count at full shapes
VLM_PATCHES = 1024


def vlm_patches(seq_len: int) -> int:
    """Image-patch prefix length: 1024 at full shapes, scaled down for
    short smoke sequences."""
    return min(VLM_PATCHES, max(seq_len // 4, 1))


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) runnable?  ``long_500k`` needs sub-quadratic
    attention state (``ModelConfig.sub_quadratic``: the xLSTM, or a
    hybrid with sliding attention)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention state; "
                       f"{cfg.name} is full-attention")
    return True, ""


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy of ``logits`` (..., V) at ``labels``,
    the logsumexp in f32; with ``mask``, the mean over the tokens it
    marks.  Under autograd only ``logits`` itself is kept for the
    backward, which forms its f32 copy again: at qwen3-0.6b's vocab
    that copy is the largest tensor of a train step.  DTensor logits
    stay on their shards (``_sharded_nll``)."""
    if is_dtensor(logits):
        return _mean(_sharded_nll(logits, labels), mask)
    if not (torch.is_grad_enabled() and logits.requires_grad):
        return _xent(logits, labels, mask)
    return checkpoint(_xent, logits, labels, mask, use_reentrant=False)


def _mean(nll: Any, mask: torch.Tensor | None) -> Any:
    """``_xent``'s mean of the DTensor ``nll``, over the tokens ``mask``
    marks if given, on ``nll``'s layout (a sum over the count: the
    backward of ``mean`` would form the whole batch's gradient on every
    rank)."""
    if mask is None:
        return nll.sum() / nll.numel()
    mask = _laid_out(mask, nll.device_mesh, nll.placements).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _laid_out(x: torch.Tensor, mesh: Any, placements: Any) -> Any:
    """``x`` (a DTensor, or a plain tensor every rank holds whole) on
    ``placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements)


def _sharded_nll(logits: Any, labels: torch.Tensor) -> Any:
    """The per-token loss of DTensor ``logits`` (B, S, V), as a DTensor
    laid out as the logits' rows: a vocab-parallel cross entropy, each
    rank on its own (B_local, S_local, V_local) block (``_LocalNLL``).
    The batch and sequence stay sharded; along a sharded vocab the
    row's max, its sum of exps and the label's logit are all-reduced
    over the vocab's mesh dims, the only collectives.  A partial sum is
    made whole first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = logits.device_mesh
    vocab = Shard(logits.ndim - 1)
    whole = [Replicate() if p.is_partial() else p for p in logits.placements]
    if whole != list(logits.placements):
        logits = logits.redistribute(mesh, whole)
    dims = tuple(i for i, p in enumerate(whole) if p == vocab)
    rows = [Replicate() if p == vocab else p for p in whole]
    labels = _laid_out(labels, mesh, rows)
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                      whole)
    nll = _LocalNLL.apply(logits.to_local(), labels.to_local(),
                          offset[-1], mesh, dims)
    return DTensor.from_local(nll, mesh, rows, run_check=False)


class _LocalNLL(torch.autograd.Function):
    """``logz - logit[label]`` of a rank's block of logits (..., V_local),
    vocab entries ``[v0, v0 + V_local)``, all-reduced over the mesh dims
    ``dims`` that shard the vocab; f32.  Keeps the block in its own
    dtype and the f32 ``logz``; the backward, ``softmax - one-hot`` on
    the block, needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, v0, mesh, dims):
        import torch.distributed._functional_collectives as funcol

        def over_vocab(x, op):
            for d in dims:
                x = funcol.all_reduce(x, op, (mesh, d))
                if isinstance(x, funcol.AsyncCollectiveTensor):
                    x = x.wait()
            return x

        n = logits.shape[-1]
        labels = labels.long() - v0
        here = (labels >= 0) & (labels < n)
        idx = labels.clamp(0, n - 1)[..., None]
        top = over_vocab(logits.amax(dim=-1).float(), "max")
        sumexp = over_vocab(
            torch.sub(logits, top[..., None]).exp_().sum(dim=-1), "sum")
        picked = over_vocab(torch.where(
            here, logits.gather(-1, idx)[..., 0].float(), 0.0), "sum")
        logz = sumexp.log() + top
        ctx.save_for_backward(logits, logz, idx, here)
        return logz - picked

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, here = ctx.saved_tensors
        grad = torch.sub(logits, logz[..., None]).exp_()
        grad.scatter_add_(-1, idx, -here.to(grad.dtype)[..., None])
        return grad.mul_(g[..., None]).to(logits.dtype), None, None, None, None


class Model:
    """Any family's model behind one interface, on ``device`` (default
    ``cuda``, which must be present)."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> dict[str, Any]:
        """Weights drawn from ``gen`` (a generator on the model's
        device)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return whisper.whisper_init(gen, cfg, self.device)
        if cfg.family == "ssm":
            return xlstm.xlstm_lm_init(gen, cfg, self.device)
        return transformer.lm_init(gen, cfg, self.device)

    def _fresh_cache(self, batch: int, max_len: int, shard: ShardFn
                     ) -> dict[str, Any]:
        mesh = shard_mesh(shard)
        if mesh is None:
            return self.init_cache(batch, max_len)
        from repro_torch.launch.steps import sharded_cache

        return sharded_cache(Model(self.cfg, "meta").init_cache(
            batch, max_len), mesh, shard.rules, self.device)

    def train_loss(self, params: dict[str, Any], batch: dict[str, Any],
                   shard: ShardFn = no_shard
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``(loss, {"xent", "aux"})`` of next-token prediction over
        ``batch["tokens"]`` (B, S) against ``batch["labels"]``, masked by
        ``batch["loss_mask"]`` if given; ``loss = xent + aux`` (``aux``,
        the MoE routers' loss summed over layers, is a zero f32 without
        experts).  An encdec model also reads ``frames`` (B, enc_seq,
        d); a vlm ``patch_embeds`` (B, P, d) before the tokens and
        ``positions`` (B, P + S, 3), its loss over the text region."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "encdec":
            enc = whisper.encode(params, batch["frames"], cfg, shard)
            logits, _ = whisper.decode(params, batch["tokens"], enc, cfg,
                                       shard=shard)
        elif cfg.family == "ssm":
            logits, _ = xlstm.xlstm_lm_apply(params, batch["tokens"], cfg,
                                             shard=shard)
        elif cfg.family == "vlm":
            x, _, aux = transformer.lm_hidden(
                params, batch["tokens"], cfg,
                input_embeds=batch["patch_embeds"],
                positions=batch["positions"], shard=shard)
            # the loss only over the text region, after the patch prefix
            logits = shard(transformer.lm_head(
                params, x[:, batch["patch_embeds"].shape[1]:], cfg),
                ("batch", "seq", "vocab"))
        else:
            logits, _, aux = transformer.lm_apply(params, batch["tokens"],
                                                  cfg, shard=shard)
        xent = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def init_cache(self, batch: int, max_len: int) -> dict[str, Any]:
        """A fresh cache for ``batch`` sequences of up to ``max_len``:
        the KV cache (``repro``'s layout); the Whisper cache with its
        cross K/V; an xLSTM's per-layer states (``max_len`` unused)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return whisper.init_whisper_cache(cfg, batch, max_len,
                                              self.device)
        if cfg.family == "ssm":
            return {"states": xlstm.init_xlstm_states(cfg, batch,
                                                      self.device),
                    "len": torch.zeros((), dtype=torch.int32,
                                       device=self.device)}
        return transformer.init_cache(cfg, batch, max_len, self.device)

    def cache_specs(self, shape: ShapeSpec) -> dict[str, Any]:
        """The cache of a decode cell (``shape.global_batch`` sequences,
        ``shape.seq_len`` positions) as tensors on the ``meta`` device:
        shapes and dtypes, nothing allocated."""
        return Model(self.cfg, "meta").init_cache(shape.global_batch,
                                                  shape.seq_len)

    def input_specs(self, shape: ShapeSpec
                    ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Name -> (shape, dtype) of every model input of this cell: a
        train cell's tokens and labels, a prefill's prompt, a decode
        step's one new token; an encdec model's ``frames`` (train and
        prefill), a vlm's M-RoPE ``positions`` and, to train, its
        ``patch_embeds`` of ``vlm_patches(S)`` positions of the S."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, cd = torch.int32, cfg.compute_dtype
        frames = ((B, cfg.enc_seq, cfg.d_model), cd)
        if shape.kind == "train":
            if cfg.family == "encdec":
                return {"frames": frames, "tokens": ((B, S), i32),
                        "labels": ((B, S), i32)}
            if cfg.family == "vlm":
                P = vlm_patches(S)
                return {"tokens": ((B, S - P), i32),
                        "patch_embeds": ((B, P, cfg.d_model), cd),
                        "positions": ((B, S, 3), i32),
                        "labels": ((B, S - P), i32)}
            return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if shape.kind == "prefill":
            specs = {"tokens": ((B, S), i32)}
            if cfg.family == "encdec":
                specs["frames"] = frames
            if cfg.family == "vlm":
                specs["positions"] = ((B, S, 3), i32)
            return specs
        if shape.kind == "decode":
            specs = {"tokens": ((B, 1), i32)}
            if cfg.family == "vlm":
                specs["positions"] = ((B, 1, 3), i32)
            return specs
        raise ValueError(f"unknown cell kind {shape.kind!r}")

    def prefill(self, params: dict[str, Any], batch: dict[str, Any],
                max_len: int, shard: ShardFn = no_shard
                ) -> tuple[torch.Tensor, dict[str, Any]]:
        """The prompt ``batch["tokens"]`` (B, S) into a fresh cache of
        ``max_len`` -> (last-position logits (B, V), cache).  An encdec
        model encodes ``batch["frames"]`` first; a vlm takes an optional
        ``patch_embeds`` (B, P, d) before the tokens and ``positions``
        (B, P + S, 3).  With ``attn_impl="blocked"`` and a prompt that
        fills the cache, every decoder layer runs the flash-attention
        kernel; an xLSTM keeps no cache of positions (``max_len``
        unused)."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if cfg.family == "encdec":
            enc = whisper.encode(params, batch["frames"], cfg, shard)
            x, cache = whisper.decode_hidden(
                params, tokens, enc, cfg,
                self._fresh_cache(B, max_len, shard), shard)
            return shard(x[:, -1] @ params["lm_head"].to(cd),
                         ("batch", "vocab")), cache
        if cfg.family == "ssm":
            x, states = xlstm.xlstm_hidden(params, tokens, cfg, shard=shard)
            cache = {"states": states,
                     "len": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                         device=self.device)}
            return shard(x[:, -1] @ params["embed"].T.to(cd),
                         ("batch", "vocab")), cache
        x, cache, _ = transformer.lm_hidden(
            params, tokens, cfg, input_embeds=batch.get("patch_embeds"),
            positions=batch.get("positions"),
            cache=self._fresh_cache(B, max_len, shard), shard=shard)
        return shard(transformer.lm_head(params, x[:, -1], cfg),
                     ("batch", "vocab")), cache

    def decode_step(self, params: dict[str, Any], tokens: torch.Tensor,
                    cache: dict[str, Any],
                    positions: torch.Tensor | None = None,
                    shard: ShardFn = no_shard
                    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """tokens (B, 1) -> (logits (B, V), new cache); a vlm needs its
        ``positions`` (B, 1, 3)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            logits, cache = whisper.decode(params, tokens, None, cfg, cache,
                                           shard)
        elif cfg.family == "ssm":
            logits, states = xlstm.xlstm_lm_apply(params, tokens, cfg,
                                                  cache["states"], shard)
            cache = {"states": states, "len": cache["len"] + 1}
        else:
            logits, cache, _ = transformer.lm_apply(
                params, tokens, cfg, positions=positions, cache=cache,
                shard=shard)
        return logits[:, -1], cache


def build_model(cfg: ModelConfig,
                device: torch.device | str | None = None) -> Model:
    return Model(cfg, device)


__all__ = ["Model", "SHAPES", "ShapeSpec", "VLM_PATCHES", "build_model",
           "cell_supported", "softmax_xent", "vlm_patches"]
