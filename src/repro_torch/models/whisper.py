"""Whisper-style encoder-decoder of the ``encdec`` family,
whisper-large-v3 (``repro/models/whisper.py``).

The conv/mel frontend is a stub, as in ``repro``: the model takes
precomputed (B, enc_seq, d_model) frame embeddings.  Encoder:
bidirectional self-attention over the frames plus sinusoidal positions.
Decoder: learned positions, causal self-attention (KV-cached), and
cross-attention over the encoder's output, whose K/V a prefill computes
once and writes to the cache, and every decode step reads from there.
Attention is ``mha``, plain PyTorch, as ``repro`` computes it with
``layers.mha`` and no blocked path.

The cache is ``repro``'s: ``k``/``v`` (layers, B, max_len, H, hd),
``xk``/``xv`` (layers, B, enc_seq, H, hd) and ``len``; the port writes
it in place, as its other caches (``models/layers.py::attention``), so
a caller must not reuse a cache it passed in.  The decoder reads its
positions from ``len`` clamped so that ``len + S <= max_seq``, as
``lax.dynamic_slice`` clamps its start.

``shard`` is ``repro``'s shard points (the encoder's input, the
decoder's embeddings, each MLP and each layer's output, the logits).
Under a mesh ``mha`` runs on DTensors; every weight is gathered over
its FSDP dims at its use, and a projection whose sharded columns do not
split into whole heads (20 heads over a model axis of 16) is gathered
whole (``common.py::weight``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    dense_init,
    embed_init,
    is_dtensor,
    no_shard,
    weight,
)
from repro_torch.models.layers import (
    _slice_index,
    _write_rows,
    apply_mlp,
    apply_norm,
    attn_init,
    causal_mask,
    copy_into,
    embed_rows,
    init_kv_cache,
    mha,
    mlp_init,
    norm_init,
)
from repro_torch.models.remat import remat_call
from repro_torch.models.transformer import unstack_layers


def _sinusoidal(S: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, cfg: ModelConfig,
           shard: ShardFn) -> torch.Tensor:
    """``x @ w`` (B, S, n * hd) as (B, S, n, hd); a DTensor weight is
    gathered over its FSDP dims, and whole where its sharded columns do
    not split into whole heads (``common.py::weight``)."""
    B, S = x.shape[:2]
    w = weight(w, cfg.compute_dtype, shard, heads=(1, n))
    return (x @ w).reshape(B, S, n, cfg.hd)


def _proj_qkv(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, shard: ShardFn) -> tuple[torch.Tensor, ...]:
    return (_heads(x, p["wq"], cfg.n_heads, cfg, shard),
            _heads(x, p["wk"], cfg.n_kv_heads, cfg, shard),
            _heads(x, p["wv"], cfg.n_kv_heads, cfg, shard))


def _out(p: dict[str, torch.Tensor], out: torch.Tensor, cfg: ModelConfig,
         shard: ShardFn) -> torch.Tensor:
    """The attention output (B, S, H, hd) through ``p["wo"]``."""
    B, S = out.shape[:2]
    return out.reshape(B, S, cfg.q_dim) @ weight(
        p["wo"], cfg.compute_dtype, shard, heads=(0, cfg.n_heads))


def whisper_init(gen: torch.Generator, cfg: ModelConfig, device
                 ) -> dict[str, Any]:
    """``enc_layers`` (leaves stacked on a leading ``enc_layers`` dim:
    ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``), ``enc_norm``,
    ``dec_embed`` (V, d), ``dec_pos`` (max_seq, d), ``dec_layers``
    (stacked on ``n_layers``: ``self_norm``, ``self_attn``,
    ``cross_norm``, ``cross_attn``, ``mlp_norm``, ``mlp``),
    ``dec_norm`` and ``lm_head`` (d, V)."""
    enc, dec = (cfg.enc_layers,), (cfg.n_layers,)
    dec_pos = torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                          dtype=torch.float32, device=device) * 0.01
    return {
        "enc_layers": {
            "attn_norm": norm_init(cfg, device, enc),
            "attn": attn_init(gen, cfg, device, enc),
            "mlp_norm": norm_init(cfg, device, enc),
            "mlp": mlp_init(gen, cfg, device, enc),
        },
        "enc_norm": norm_init(cfg, device),
        "dec_embed": embed_init(gen, cfg.vocab, cfg.d_model,
                                cfg.param_dtype, device),
        "dec_pos": dec_pos.to(cfg.param_dtype),
        "dec_layers": {
            "self_norm": norm_init(cfg, device, dec),
            "self_attn": attn_init(gen, cfg, device, dec),
            "cross_norm": norm_init(cfg, device, dec),
            "cross_attn": attn_init(gen, cfg, device, dec),
            "mlp_norm": norm_init(cfg, device, dec),
            "mlp": mlp_init(gen, cfg, device, dec),
        },
        "dec_norm": norm_init(cfg, device),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype,
                              device),
    }


def encode(params: dict[str, Any], frames: torch.Tensor, cfg: ModelConfig,
           shard: ShardFn = no_shard) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> encoder states (B, T, d);
    ``shard`` at ``repro``'s points (the input, each MLP, each layer's
    output)."""
    cd = cfg.compute_dtype
    T, d = frames.shape[1:]
    x = frames.to(cd) + _sinusoidal(T, d, frames.device).to(cd)[None]
    x = shard(x, ("batch", "seq", "embed"))
    for lp in unstack_layers(params["enc_layers"], cfg.enc_layers):
        x = remat_call(_encoder_layer, cfg, lp, x, cfg, shard)
    return apply_norm(params["enc_norm"], x, cfg)


def _encoder_layer(lp: dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                   shard: ShardFn) -> torch.Tensor:
    """One pre-norm encoder layer: bidirectional self-attention, MLP."""
    normed = apply_norm(lp["attn_norm"], x, cfg)
    q, k, v = _proj_qkv(lp["attn"], normed, cfg, shard)
    x = x + _out(lp["attn"], mha(q, k, v, None, cfg), cfg, shard)
    x = x + apply_mlp(lp["mlp"], apply_norm(lp["mlp_norm"], x, cfg), cfg,
                      shard)
    return shard(x, ("batch", "seq", "embed"))


def decode_hidden(params: dict[str, Any], tokens: torch.Tensor,
                  enc_out: torch.Tensor | None, cfg: ModelConfig,
                  cache: dict[str, torch.Tensor] | None = None,
                  shard: ShardFn = no_shard
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """The decoder's final-normed hidden state (B, S, d) and the new
    cache (None without one).  Without a cache: causal self-attention
    over ``tokens`` and cross-attention over ``enc_out``.  With one, the
    self-attention K/V rows are written at ``len`` and attend to the
    history; ``enc_out`` given (a prefill) builds the cross K/V and
    writes them to ``xk``/``xv``, None (a decode step) reads them
    there.  ``shard`` at ``repro``'s points (the embeddings, each MLP,
    each layer's output); the cross K/V are written into the rank's own
    shard of ``xk``/``xv``."""
    cd = cfg.compute_dtype
    S = tokens.shape[1]
    x = embed_rows(params["dec_embed"], tokens).to(cd)
    table = params["dec_pos"]
    if is_dtensor(table):               # positions are picked whole
        from torch.distributed.tensor import Replicate

        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    if cache is None:
        pos = table[:S]
        cache_len = None
    else:
        cache_len = cache["len"]
        if is_dtensor(cache_len):       # replicated: the local value
            cache_len = cache_len.to_local()
        index = _slice_index(cache_len, S, cfg.max_seq)
        if is_dtensor(table):
            from torch.distributed.tensor import DTensor

            index = DTensor.from_local(index, table.device_mesh,
                                       table.placements, run_check=False)
        pos = table.index_select(0, index)
    x = shard(x + pos.to(cd)[None], ("batch", "seq", "embed"))
    build_cross = cache is None or enc_out is not None
    layers = unstack_layers(params["dec_layers"], cfg.n_layers)
    for i, lp in enumerate(layers):
        if cache is None:
            x = remat_call(_decoder_layer, cfg, lp, x, enc_out, cfg, shard)
        else:
            x = _decoder_layer(lp, x, enc_out, cfg, shard, cache, i,
                               cache_len, build_cross)
    new_cache = None
    if cache is not None:
        # written in place: the cache's tensors are the new cache
        new_cache = {k: v for k, v in cache.items() if k != "len"}
        new_cache["len"] = cache_len + S
    return apply_norm(params["dec_norm"], x, cfg), new_cache


def _decoder_layer(lp: dict[str, Any], x: torch.Tensor,
                   enc_out: torch.Tensor | None, cfg: ModelConfig,
                   shard: ShardFn,
                   cache: dict[str, torch.Tensor] | None = None,
                   i: int = 0, cache_len: torch.Tensor | None = None,
                   build_cross: bool = True) -> torch.Tensor:
    """Decoder layer ``i``: causal self-attention (over ``x`` alone, or
    with its K/V rows written into ``cache`` at ``cache_len``),
    cross-attention over ``enc_out`` (its K/V written to the cache when
    ``build_cross`` and a cache is given; read from there when not
    ``build_cross``), MLP."""
    S = x.shape[1]
    dev = x.device
    # causal self-attention, cached or not
    q, k, v = _proj_qkv(lp["self_attn"],
                        apply_norm(lp["self_norm"], x, cfg), cfg, shard)
    if cache is None:
        out = mha(q, k, v, causal_mask(S, S, device=dev), cfg)
    else:
        ck, cv = cache["k"][i], cache["v"][i]
        L = ck.shape[1]
        _write_rows((ck, cv), (k, v), _slice_index(cache_len, S, L))
        qpos = cache_len + torch.arange(S, device=dev)[:, None]
        valid = torch.arange(L, device=dev)[None, :] <= qpos
        out = mha(q, ck, cv, valid[None, None], cfg)
    x = x + _out(lp["self_attn"], out, cfg, shard)

    # cross-attention over the encoder states
    xa = lp["cross_attn"]
    qc = _heads(apply_norm(lp["cross_norm"], x, cfg), xa["wq"],
                cfg.n_heads, cfg, shard)
    if build_cross:
        kc = _heads(enc_out, xa["wk"], cfg.n_kv_heads, cfg, shard)
        vc = _heads(enc_out, xa["wv"], cfg.n_kv_heads, cfg, shard)
        if cache is not None:
            copy_into(cache["xk"][i], kc)
            copy_into(cache["xv"][i], vc)
    else:
        kc, vc = cache["xk"][i], cache["xv"][i]
    out = mha(qc, kc, vc, None, cfg)
    x = x + _out(xa, out, cfg, shard)
    x = x + apply_mlp(lp["mlp"], apply_norm(lp["mlp_norm"], x, cfg), cfg,
                      shard)
    return shard(x, ("batch", "seq", "embed"))


def decode(params: dict[str, Any], tokens: torch.Tensor,
           enc_out: torch.Tensor | None, cfg: ModelConfig,
           cache: dict[str, torch.Tensor] | None = None,
           shard: ShardFn = no_shard
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """``decode_hidden`` then the LM head: (logits (B, S, V) in the
    compute dtype, sharded over ``vocab``, the new cache)."""
    x, cache = decode_hidden(params, tokens, enc_out, cfg, cache, shard)
    return shard(x @ weight(params["lm_head"], cfg.compute_dtype, shard),
                 ("batch", "seq", "vocab")), cache


def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int, device
                       ) -> dict[str, torch.Tensor]:
    """``init_kv_cache`` over the decoder's layers plus zero ``xk``/``xv``
    (layers, B, enc_seq, Hkv, hd) in the compute dtype."""
    kv = init_kv_cache(cfg, batch, max_len, cfg.n_layers, device)
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": kv["k"], "v": kv["v"],
            "xk": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "xv": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "len": kv["len"]}


__all__ = ["decode", "decode_hidden", "encode", "init_whisper_cache",
           "whisper_init"]
