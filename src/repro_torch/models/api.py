"""The model facade (``repro/models/api.py``) for the dense, MoE and
hybrid decoder families.

``build_model(cfg)`` returns a ``Model`` with ``init``, ``train_loss``,
``init_cache``, ``prefill`` and ``decode_step``, so the train and
serving steps (``launch/steps.py``) never dispatch on the config.
Shape cells pair an arch with ``train_4k``, ``prefill_32k``,
``decode_32k`` or ``long_500k``.

Differences from ``repro``, by design: ``init`` draws from a
``torch.Generator`` (to run ``repro``'s weights, load them with
``rl/policy_lm.py::params_from_jax``); caches are written in place
(``models/layers.py::attention``), so a caller must not reuse a cache
it passed to ``decode_step``; ``prefill`` applies the LM head to the
last position only, where ``repro`` takes ``logits[:, -1]`` of the
full-sequence head and XLA drops the rest (eager PyTorch would compute
all of it: 10 GB and 10 TFLOP at qwen3-0.6b, B=4, S=8192);
``softmax_xent`` forms the f32 copy of the logits again in the backward
(``torch.utils.checkpoint``), where XLA decides itself what to keep.
The ``ssm``, ``encdec`` and ``vlm`` families are not ported: ``Model``
refuses them, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


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


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) runnable?  ``long_500k`` needs sub-quadratic
    attention state (``ModelConfig.sub_quadratic``: a hybrid with sliding
    attention among the ported families)."""
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
    that copy is the largest tensor of a train step."""
    if not (torch.is_grad_enabled() and logits.requires_grad):
        return _xent(logits, labels, mask)
    return checkpoint(_xent, logits, labels, mask, use_reentrant=False)


class Model:
    """A dense, MoE or hybrid decoder behind one interface, on
    ``device`` (default ``cuda``, which must be present)."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None):
        transformer.check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> dict[str, Any]:
        """Weights drawn from ``gen`` (a generator on the model's
        device)."""
        return transformer.lm_init(gen, self.cfg, self.device)

    def train_loss(self, params: dict[str, Any], batch: dict[str, Any]
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``(loss, {"xent", "aux"})`` of next-token prediction over
        ``batch["tokens"]`` (B, S) against ``batch["labels"]`` (B, S),
        masked by ``batch["loss_mask"]`` if given; ``loss = xent + aux``
        (``aux``, the MoE routers' loss summed over layers, is a zero f32
        without experts)."""
        logits, _, aux = transformer.lm_apply(params, batch["tokens"],
                                              self.cfg)
        xent = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def init_cache(self, batch: int, max_len: int) -> dict[str, Any]:
        return transformer.init_cache(self.cfg, batch, max_len, self.device)

    def input_specs(self, shape: ShapeSpec
                    ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Name -> (shape, dtype) of every model input of this cell: a
        train cell's tokens and labels, a prefill's prompt, a decode
        step's one new token."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": ((B, S), torch.int32),
                    "labels": ((B, S), torch.int32)}
        if shape.kind == "prefill":
            return {"tokens": ((B, S), torch.int32)}
        if shape.kind == "decode":
            return {"tokens": ((B, 1), torch.int32)}
        raise ValueError(f"unknown cell kind {shape.kind!r}")

    def prefill(self, params: dict[str, Any], batch: dict[str, Any],
                max_len: int) -> tuple[torch.Tensor, dict[str, Any]]:
        """The prompt ``batch["tokens"]`` (B, S) into a fresh cache of
        ``max_len`` -> (last-position logits (B, V), cache).  With
        ``attn_impl="blocked"`` and ``max_len == S`` every layer runs the
        flash-attention kernel."""
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], max_len)
        x, cache, _ = transformer.lm_hidden(params, tokens, self.cfg,
                                            cache=cache)
        return transformer.lm_head(params, x[:, -1], self.cfg), cache

    def decode_step(self, params: dict[str, Any], tokens: torch.Tensor,
                    cache: dict[str, Any],
                    positions: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """tokens (B, 1) -> (logits (B, V), new cache)."""
        logits, cache, _ = transformer.lm_apply(
            params, tokens, self.cfg, positions=positions, cache=cache)
        return logits[:, -1], cache


def build_model(cfg: ModelConfig,
                device: torch.device | str | None = None) -> Model:
    return Model(cfg, device)


__all__ = ["Model", "SHAPES", "ShapeSpec", "build_model", "cell_supported",
           "softmax_xent"]
