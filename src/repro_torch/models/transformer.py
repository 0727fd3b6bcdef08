"""Dense decoder-only LM (``repro/models/transformer.py``): stacked-layer
parameters and the no-cache forward.

``lm_apply`` is the JAX package's train-mode forward for the dense
family: embed, ``n_layers`` of pre-norm attention + MLP over the stacked
layer weights, final norm, logits.  It returns the logits only (the JAX
function also returns an empty cache and a zero MoE loss).  The cached
decode lives in ``rl/policy_lm.py::LMPolicy.decode_step``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import ModelConfig, dense_init, embed_init
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    attention,
    attn_init,
    mlp_init,
    norm_init,
    rope_tables,
)


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; only dense "
            "decoders are (ROADMAP A)")


def lm_init(gen: torch.Generator, cfg: ModelConfig,
            device: torch.device | str) -> dict[str, Any]:
    """Parameters drawn from ``gen`` on ``device``: ``embed`` (V, d),
    ``layers`` with every leaf stacked on a leading ``n_layers`` dim,
    ``final_norm``, and ``lm_head`` unless embeddings are tied.  The
    draws are torch's, not ``jax.random``'s; to run the JAX package's
    weights, load them with ``rl/policy_lm.py::params_from_jax``."""
    check_dense(cfg)
    lead = (cfg.n_layers,)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                            device),
        "layers": {
            "attn_norm": norm_init(cfg, device, lead),
            "attn": attn_init(gen, cfg, device, lead),
            "mlp_norm": norm_init(cfg, device, lead),
            "mlp": mlp_init(gen, cfg, device, lead),
        },
        "final_norm": norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                  cfg.param_dtype, device)
    return p


def layer_params(layers: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer ``i``'s slice of the stacked layer parameters (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def lm_head(params: dict[str, Any], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Logits from the final-normed hidden state: the tied embedding or
    the separate LM head."""
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(cd)
    return x @ params["lm_head"].to(cd)


def lm_apply(params: dict[str, Any], tokens: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """(B, S) int tokens -> (B, S, V) logits in the compute dtype, full
    causal attention, positions ``0..S-1``."""
    check_dense(cfg)
    cd = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cd)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = rope_tables(positions, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        x = x + attention(lp["attn"], apply_norm(lp["attn_norm"], x, cfg),
                          cfg, rope)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["mlp_norm"], x, cfg),
                          cfg)
    return lm_head(params, apply_norm(params["final_norm"], x, cfg), cfg)


__all__ = ["check_dense", "layer_params", "lm_apply", "lm_head",
           "lm_init"]
