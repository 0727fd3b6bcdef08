"""Decoder-only LM of the dense, MoE, hybrid and vlm families
(``repro/models/transformer.py``): stacked-layer parameters, the forward
with and without a cache, and the cache.

``lm_apply`` is the JAX package's forward: embed, ``n_layers`` of
pre-norm attention + FFN over the stacked layer weights, final norm,
logits.  The FFN is the MLP, or the routed experts of ``models/moe.py``
for ``cfg.moe``; a hybrid (``cfg.ssm``) runs attention and the SSM of
``models/ssm.py`` side by side on the same normed input.  It returns
``(logits, new_cache, aux)`` as ``repro``'s does, ``aux`` the MoE
routers' loss summed over layers (a zero f32 without experts).  Layers
run one after another in Python, each with its static window
(``static_layer_windows``), as ``repro`` runs them with
``scan_layers=False``; without a cache each layer runs under
``models/remat.py::remat_call`` (``cfg.remat``), as ``repro`` wraps it
in ``_remat``.  The cache is ``repro``'s: ``k``/``v`` (layers,
B, L, Hkv, hd), ``len`` a 0-d int32 (plus ``k_scale``/``v_scale`` for
the int8 cache, ``ssm_h``/``ssm_tail`` for a hybrid), written in place
(``models/layers.py::attention``, ``decoder_layer``).  The LM policy's
own cached decode lives in ``rl/policy_lm.py``.

``shard`` is ``repro``'s shard points (the embeddings, each layer's
output, the logits; ``no_shard`` by default), passed on to the
attention, the MLP, the experts (``models/moe.py``) and the SSM branch
(``models/ssm.py``).  Under a mesh the weights are DTensors and the
embedding is looked up vocab-parallel (``layers.py::embed_rows``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    dense_init,
    embed_init,
    no_shard,
)
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    attention,
    attn_init,
    copy_into,
    embed_rows,
    init_kv_cache,
    mlp_init,
    norm_init,
    rope_tables,
)
from repro_torch.models.moe import apply_moe, moe_init
from repro_torch.models.remat import remat_call
from repro_torch.models.ssm import apply_ssm, init_ssm_state, ssm_init


def lm_init(gen: torch.Generator, cfg: ModelConfig,
            device: torch.device | str) -> dict[str, Any]:
    """Parameters drawn from ``gen`` on ``device``: ``embed`` (V, d),
    ``layers`` with every leaf stacked on a leading ``n_layers`` dim
    (``moe`` in place of ``mlp`` for an MoE config, neither for
    ``d_ff == 0``; ``ssm``,
    ``attn_out_norm`` and ``ssm_out_norm`` for a hybrid),
    ``final_norm``, and ``lm_head`` unless embeddings are tied.  The
    draws are torch's, not ``jax.random``'s; to run the JAX package's
    weights, load them with ``rl/policy_lm.py::params_from_jax``."""
    lead = (cfg.n_layers,)
    layers = {
        "attn_norm": norm_init(cfg, device, lead),
        "attn": attn_init(gen, cfg, device, lead),
        "mlp_norm": norm_init(cfg, device, lead),
    }
    if cfg.moe is not None:
        layers["moe"] = moe_init(gen, cfg, device, lead)
    elif cfg.d_ff > 0:
        layers["mlp"] = mlp_init(gen, cfg, device, lead)
    if cfg.ssm is not None:
        layers["ssm"] = ssm_init(gen, cfg, device, lead)
        layers["attn_out_norm"] = norm_init(cfg, device, lead)
        layers["ssm_out_norm"] = norm_init(cfg, device, lead)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                            device),
        "layers": layers,
        "final_norm": norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                  cfg.param_dtype, device)
    return p


def unstack_layers(layers: dict[str, Any], n: int) -> list[dict[str, Any]]:
    """The stacked layer parameters as ``n`` per-layer dicts of views,
    each leaf split once (``torch.unbind``).  Under autograd the slices'
    gradients then go into the stacked leaf's gradient in one stack,
    where ``n`` separate index views (``v[i]``) would each add a
    zero-filled gradient of the whole stacked leaf into it (``n`` times
    the traffic of the leaf, in every train step)."""
    out: list[dict[str, Any]] = [{} for _ in range(n)]
    for k, v in layers.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def lm_head(params: dict[str, Any], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Logits from the final-normed hidden state: the tied embedding or
    the separate LM head."""
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(cd)
    return x @ params["lm_head"].to(cd)


def static_layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer windows as Python ints (0 = full attention)."""
    if cfg.attn_type != "sliding":
        return [0] * cfg.n_layers
    return [0 if i in cfg.global_attn_layers else cfg.window
            for i in range(cfg.n_layers)]


def decoder_layer(p: dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                  rope: tuple[torch.Tensor, torch.Tensor] | None,
                  layer_window: int,
                  cache: dict[str, torch.Tensor] | None,
                  cache_len: torch.Tensor | None,
                  shard: ShardFn = no_shard
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One pre-norm layer -> (x, the MoE aux loss or None without
    experts); ``cache`` is this layer's slice of the cache (without
    ``len``), written in place."""
    cache_kv = cache_scales = None
    if cache is not None:
        cache_kv = (cache["k"], cache["v"])
        if "k_scale" in cache:
            cache_scales = (cache["k_scale"], cache["v_scale"])
    normed = apply_norm(p["attn_norm"], x, cfg)
    attn_out = attention(p["attn"], normed, cfg, rope,
                         layer_window=layer_window, cache_kv=cache_kv,
                         cache_scales=cache_scales, cache_len=cache_len,
                         shard=shard)
    if cfg.ssm is not None:
        # hymba: parallel attention + SSM heads, normed-mean fusion
        state = None if cache is None else (cache["ssm_h"],
                                            cache["ssm_tail"])
        ssm_out, (h, tail) = apply_ssm(p["ssm"], normed, cfg, state, shard)
        if cache is not None:
            copy_into(cache["ssm_h"], h)
            copy_into(cache["ssm_tail"], tail)
        x = x + 0.5 * (apply_norm(p["attn_out_norm"], attn_out, cfg)
                       + apply_norm(p["ssm_out_norm"], ssm_out, cfg))
    else:
        x = x + attn_out
    normed = apply_norm(p["mlp_norm"], x, cfg)
    if cfg.moe is not None:
        out, aux = apply_moe(p["moe"], normed, cfg, shard)
        return shard(x + out, ("batch", "seq", "embed")), aux
    if cfg.d_ff > 0:
        x = x + apply_mlp(p["mlp"], normed, cfg, shard)
    return shard(x, ("batch", "seq", "embed")), None


def lm_hidden(params: dict[str, Any], tokens: torch.Tensor | None,
              cfg: ModelConfig, *,
              input_embeds: torch.Tensor | None = None,
              positions: torch.Tensor | None = None,
              cache: dict[str, torch.Tensor] | None = None,
              shard: ShardFn = no_shard
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None,
                         torch.Tensor]:
    """The final-normed hidden state (B, S, d), the new cache and the
    aux loss summed over layers (a 0-dim f32): every step of
    ``lm_apply`` but the LM head, which ``Model.prefill`` applies to the
    last position only."""
    cd = cfg.compute_dtype
    parts = []
    if input_embeds is not None:
        parts.append(input_embeds.to(cd))
    if tokens is not None:
        parts.append(embed_rows(params["embed"], tokens).to(cd))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    x = shard(x, ("batch", "seq", "embed"))
    S = x.shape[1]
    cache_len = cache["len"] if cache is not None else None
    if positions is None:
        # one row for every sequence: the tables broadcast over the
        # batch, whose rows a mesh shards (a whole (B, S) table would
        # hold every rank's rows)
        positions = torch.arange(S, device=x.device)[None, :]
        if cache is not None:
            positions = positions + cache_len
    rope = rope_tables(positions, cfg)
    layers = unstack_layers(params["layers"], cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(static_layer_windows(cfg)):
        if cache is not None:
            layer_cache = {k: v[i] for k, v in cache.items() if k != "len"}
            x, layer_aux = decoder_layer(layers[i], x, cfg, rope, w,
                                         layer_cache, cache_len, shard)
        else:
            x, layer_aux = remat_call(decoder_layer, cfg, layers[i], x, cfg,
                                      rope, w, None, None, shard)
        if layer_aux is not None:
            aux = aux + layer_aux
    new_cache = None
    if cache is not None:
        # the layer caches are views of the stacked tensors, written in
        # place: the stacked tensors are the new cache
        new_cache = {k: v for k, v in cache.items() if k != "len"}
        new_cache["len"] = cache_len + S
    return apply_norm(params["final_norm"], x, cfg), new_cache, aux


def lm_apply(params: dict[str, Any], tokens: torch.Tensor | None,
             cfg: ModelConfig, *,
             input_embeds: torch.Tensor | None = None,
             positions: torch.Tensor | None = None,
             cache: dict[str, torch.Tensor] | None = None,
             shard: ShardFn = no_shard
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None,
                        torch.Tensor]:
    """(B, S) int tokens -> ``(logits (B, S, V) in the compute dtype,
    new_cache, aux)``.  ``input_embeds`` (B, P, d), if given, come
    before the token embeddings (``tokens`` may then be None), and
    ``positions`` must cover the P + S entries.  Positions default to
    ``cache["len"] + 0..S-1`` (``0..S-1`` without a cache); M-RoPE
    needs them given, (B, S, 3).  ``new_cache`` is None without a
    cache; ``aux`` is the MoE loss summed over layers, a 0-dim f32."""
    x, new_cache, aux = lm_hidden(params, tokens, cfg,
                                  input_embeds=input_embeds,
                                  positions=positions, cache=cache,
                                  shard=shard)
    return (shard(lm_head(params, x, cfg), ("batch", "seq", "vocab")),
            new_cache, aux)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict[str, torch.Tensor]:
    """``init_kv_cache`` over every layer, plus a hybrid's zero SSM state
    ``ssm_h`` (layers, B, di, n) and ``ssm_tail`` (layers, B, W-1, di)
    in the compute dtype; the ring cache is sized to the window only
    when every layer is a sliding one."""
    window = None
    if (cfg.windowed_cache and cfg.attn_type == "sliding"
            and not cfg.global_attn_layers):
        window = cfg.window
    cache = init_kv_cache(cfg, batch, max_len, cfg.n_layers, device,
                          window=window)
    if cfg.ssm is not None:
        cache["ssm_h"], cache["ssm_tail"] = init_ssm_state(
            cfg, batch, cfg.n_layers, device)
    return cache


__all__ = ["decoder_layer", "init_cache",
           "lm_apply", "lm_head", "lm_hidden", "lm_init",
           "static_layer_windows", "unstack_layers"]
