"""Transformer layers (``repro/models/layers.py``): norms, RoPE and
M-RoPE, GQA attention with and without a KV cache, MLPs.

Plain functions over parameter dicts, in the JAX package's layout and
with its casts: every weight is cast to the compute dtype at use, norms
and softmax run in float32 and cast back.  ``attention`` keeps
``repro``'s branches and their order: no cache (dense masked, or
blocked on the flash-attention kernel), the int8 cache, the ring cache
of ``windowed_cache`` (decode only), and the exact cache (blocked when
a prefill fills the whole cache, dense masked otherwise).  Dense and
int8 attention over a cache are plain torch (``mha``), as ``repro``
computes them outside any Pallas kernel.

Where ``repro`` returns updated caches, the port writes the new K/V
rows into the cache tensors it is given (views of the stacked
``(layers, B, L, Hkv, D)`` cache): a caller must not reuse a cache it
passed in.  The write starts at ``min(cache_len, L -
S)``, clamped as ``dynamic_update_slice`` clamps, and is an index op on
the device: ``cache_len`` never leaves the card.

``shard`` is ``repro``'s shard points (q, k, v after the rotation, the
attention output, the MLP's hidden and output), ``no_shard`` by
default.  Under a mesh the tensors are DTensors: the blocked attention
runs the kernel on each rank's local heads
(``models/blocked_attention.py``), and a cache whose positions are
sharded takes its new rows on the rank that holds them (``_write_rows``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.blocked_attention import (
    banded_attention,
    online_causal_attention,
)
from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    dense_init,
    is_dtensor,
    no_shard,
)


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def norm_init(cfg: ModelConfig, device, lead: tuple[int, ...] = ()
              ) -> dict[str, torch.Tensor]:
    shape = lead + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=cfg.param_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(p: dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of q/k (qwen3)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    half = cfg.hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)


def rope_tables(positions: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """``(cos, sin)`` of the rotary angles at ``positions``, each (B, S,
    1, hd / 2) f32, or None for ``rope_type="none"``.  ``positions`` is
    (B, S), or (B, S, 3) for M-RoPE (qwen2-vl), where frequency ``j``
    turns by the t, h or w component as ``mrope_sections`` assigns the
    ``hd / 2`` frequencies to them in turn.  The tables depend on
    positions only, so a forward forms them once and every layer's q and
    k reuse them: XLA shares them between layers by
    common-subexpression elimination, eager PyTorch would recompute them
    for each of the 2 * n_layers calls."""
    if cfg.rope_type == "none":
        return None
    inv = rope_freqs(cfg, positions.device)
    if cfg.rope_type == "mrope":
        half, secs = cfg.hd // 2, cfg.mrope_sections
        if positions.dim() != 3:
            raise ValueError("mrope needs (B, S, 3) position ids; got "
                             f"{tuple(positions.shape)}")
        if sum(secs) != half:
            raise ValueError(f"mrope_sections {secs} do not sum to "
                             f"hd / 2 = {half}")
        sec_id = torch.tensor([i for i, n in enumerate(secs)
                               for _ in range(n)], device=positions.device)
        angles = positions.float()[..., sec_id] * inv
    else:
        angles = positions.float()[..., None] * inv
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor,
               tables: tuple[torch.Tensor, torch.Tensor] | None,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, D) rotated by ``rope_tables(positions, cfg)``; as it
    is without tables (``rope_type="none"``)."""
    if tables is None:
        return x
    cos, sin = tables
    half = cfg.hd // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, cfg: ModelConfig, device,
              lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d, pd = cfg.d_model, cfg.param_dtype
    p = {
        "wq": dense_init(gen, d, cfg.q_dim, pd, device, lead),
        "wk": dense_init(gen, d, cfg.kv_dim, pd, device, lead),
        "wv": dense_init(gen, d, cfg.kv_dim, pd, device, lead),
        "wo": dense_init(gen, cfg.q_dim, d, pd, device, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (cfg.hd,), dtype=pd, device=device)
        p["k_norm"] = torch.ones(lead + (cfg.hd,), dtype=pd, device=device)
    return p


def causal_mask(S: int, T: int, offset: int = 0, device=None
                ) -> torch.Tensor:
    """(1, 1, S, T) causal mask; query i attends keys j <= i + offset."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def sliding_mask(S: int, T: int, window: int, offset: int = 0, device=None
                 ) -> torch.Tensor:
    """(1, 1, S, T) causal mask over the ``window`` newest keys."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    return ((kpos <= qpos) & (kpos > qpos - window))[None, None]


def split_whole(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x``, ready for dim ``dim`` to be split into ``parts`` leading
    parts: a DTensor whose shards of that dim do not divide ``parts`` is
    first gathered along it (DTensor refuses such a reshape; GSPMD
    reshards).  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh, ps = x.device_mesh, x.placements
    extent = math.prod(mesh.size(i) for i, p in enumerate(ps)
                       if p == Shard(dim))
    if parts % extent == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                 for p in ps])


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor | None, cfg: ModelConfig) -> torch.Tensor:
    """Masked GQA attention, f32 softmax.  q: (B, S, Hq, D), k/v:
    (B, T, Hkv, D) -> (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = split_whole(q, 2, Hkv).reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).reshape(B, Hq, S, T)
    scores = scores.float() / math.sqrt(float(cfg.hd))
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = split_whole(torch.softmax(scores, dim=-1).to(q.dtype), 1, Hkv)
    o = torch.einsum("bkgst,btkd->bskgd", w.reshape(B, Hkv, G, S, T), v)
    return o.reshape(B, S, Hq, D)


# --------------------------------------------------------------------- #
# KV cache
# --------------------------------------------------------------------- #
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                  device, window: int | None = None
                  ) -> dict[str, torch.Tensor]:
    """Pre-allocated KV cache: ``k``/``v`` (layers, batch, L, Hkv, hd)
    and ``len`` a 0-d int32.  ``window`` caps L for the ring cache of
    sliding-window layers (``cfg.windowed_cache``).  With
    ``kv_cache_dtype="int8"`` entries are int8 with one f32 scale per
    (position, kv head) in ``k_scale``/``v_scale``."""
    L = min(max_len, window) if window else max_len
    shape = (layers, batch, L, cfg.n_kv_heads, cfg.hd)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:-1], torch.float32),
                "v_scale": zeros(shape[:-1], torch.float32),
                "len": zeros((), torch.int32)}
    return {"k": zeros(shape, cfg.compute_dtype),
            "v": zeros(shape, cfg.compute_dtype),
            "len": zeros((), torch.int32)}


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, Hkv, D) -> int8 values + (B, S, Hkv) f32 scales."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _write_rows(caches: tuple[torch.Tensor, ...],
                rows: tuple[torch.Tensor, ...], index: torch.Tensor) -> None:
    """Write ``rows[i]`` into ``caches[i]`` at positions ``index`` (a run
    of consecutive positions) of dim 1, in place."""
    for cache, new in zip(caches, rows):
        if is_dtensor(cache):
            _write_local_rows(cache, new, index)
        else:
            cache.index_copy_(1, index, new.to(cache.dtype))


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, in place, where ``dst`` may be a DTensor view
    of a cache: ``src`` laid out as ``dst`` (a plain ``src`` is the
    whole value, as implicit replication reads it) and copied into the
    rank's own shard."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    from torch.distributed.tensor import distribute_tensor

    mesh, want = dst.device_mesh, dst.placements
    src = (src.redistribute(mesh, want) if is_dtensor(src) else
           distribute_tensor(src, mesh, want, src_data_rank=None))
    dst.to_local().copy_(src.to_local())


def _write_local_rows(cache, new, index) -> None:
    """``_write_rows`` into a DTensor cache, on each rank's own shard.
    The new rows are made whole along the positions (they are few: the
    prompt, or one token).  Where the positions are not sharded each
    rank writes them with ``index_copy_``; where they are, a rank holds
    positions ``lo .. lo + Ll - 1`` and a write at a position on the
    card (``cache_len``) must land on the rank that holds it without a
    host read, so every rank rewrites its whole shard, each row from
    the new rows where its position is in the run and from itself
    elsewhere: one pass over the shard a write."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh, cp = cache.device_mesh, tuple(cache.placements)
    want = [Replicate() if p == Shard(1) else p for p in cp]
    new = new.redistribute(mesh, want) if is_dtensor(new) else new
    local = cache.to_local()
    rows = (new.to_local() if is_dtensor(new) else new).to(local.dtype)
    if not any(p == Shard(1) and mesh.size(i) > 1 for i, p in enumerate(cp)):
        local.index_copy_(1, index, rows)
        return
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cp)
    src = (offset[1] - index[0]
           + torch.arange(local.shape[1], device=local.device))
    hit = (src >= 0) & (src < rows.shape[1])
    picked = rows.index_select(1, src.clamp(0, rows.shape[1] - 1))
    hit = hit.view((1, -1) + (1,) * (local.ndim - 2))
    local.copy_(torch.where(hit, picked, local))


def _slice_index(cache_len: torch.Tensor, S: int, L: int) -> torch.Tensor:
    """Positions ``start .. start + S - 1`` with ``start = clamp(
    cache_len, 0, L - S)``, as ``dynamic_update_slice`` clamps."""
    if S > L:
        raise ValueError(f"{S} new positions do not fit a cache of {L}")
    start = torch.clamp(cache_len.long(), 0, L - S)
    return start + torch.arange(S, device=cache_len.device)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def attention(
    p: dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    *,
    layer_window: int | None = None,
    cache_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_scales: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_len: torch.Tensor | None = None,
    shard: ShardFn = no_shard,
) -> torch.Tensor:
    """GQA attention over ``x`` (B, S, d) -> (B, S, d); ``rope`` is
    ``rope_tables`` of the positions, ``layer_window`` this layer's
    window (0 = full; None = ``cfg.window`` for a sliding config).

    * no cache: causal (or sliding) self-attention over ``x``;
    * prefill: ``cache_kv`` (B, L, Hkv, hd) zeros and ``cache_len`` 0;
    * decode: ``cache_kv`` holds ``cache_len`` positions of history.

    The new K/V rows (and int8 scales) are written into ``cache_kv``
    (and ``cache_scales``) in place: they are ``repro``'s new cache."""
    B, S, _ = x.shape
    cd = cfg.compute_dtype
    q, k, v = (split_whole(x @ p[w].to(cd), 2, n).reshape(B, S, n, cfg.hd)
               for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)))
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    q = shard(apply_rope(q, rope, cfg), ("batch", "seq", "heads", None))
    k = shard(apply_rope(k, rope, cfg), ("batch", "seq", "kv_heads", None))
    v = shard(v, ("batch", "seq", "kv_heads", None))

    window = cfg.window if cfg.attn_type == "sliding" else 0
    # this layer's window; 0 = full (a global layer, or not sliding)
    win = window if layer_window is None or not window else int(layer_window)
    use_blocked = cfg.attn_impl == "blocked" and S > 1
    dev = x.device

    if cache_kv is None:
        # the train path: the dense mask, or blocked on the kernel,
        # whose gradient is the plain recompute of its backward
        if use_blocked:
            out = _blocked_self_attention(q, k, v, win)
        else:
            mask = (sliding_mask(S, S, win, device=dev) if win
                    else causal_mask(S, S, device=dev))
            out = mha(q, k, v, mask, cfg)
        return _attn_out(p, out, cfg, shard)

    ck, cv = cache_kv
    L = ck.shape[1]
    if is_dtensor(cache_len):       # replicated: the local value is whole
        cache_len = cache_len.to_local()
    qpos = cache_len + torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(L, device=dev)[None, :]
    if cache_scales is not None:
        # int8 cache: stored quantized, dequantized at use
        k_sc, v_sc = cache_scales
        kq, ks_new = _quant_kv(k)
        vq, vs_new = _quant_kv(v)
        _write_rows((ck, cv, k_sc, v_sc), (kq, vq, ks_new, vs_new),
                    _slice_index(cache_len, S, L))
        valid = kpos <= qpos
        if win:
            valid = valid & (kpos > qpos - win)
        out = mha(q, _dequant_kv(ck, k_sc, cd), _dequant_kv(cv, v_sc, cd),
                  valid[None, None], cfg)
        return _attn_out(p, out, cfg, shard)
    if cfg.windowed_cache and window and window < L:
        # ring cache (decode only): the write slot wraps modulo L
        if S != 1:
            raise ValueError("windowed_cache supports single-token decode "
                             f"only; got {S} tokens")
        _write_rows((ck, cv), (k, v), (cache_len.long() % L).reshape(1))
        mask = (kpos < torch.clamp(cache_len + 1, max=L))[None, None]
    else:
        _write_rows((ck, cv), (k, v), _slice_index(cache_len, S, L))
        if use_blocked and S == L:
            # prefill from scratch (cache_len == 0 by Model.prefill's
            # contract): blocked attention over x itself
            return _attn_out(p, _blocked_self_attention(q, k, v, win), cfg,
                             shard)
        valid = kpos <= qpos                        # causal incl. history
        if win:
            valid = valid & (kpos > qpos - win)
        mask = valid[None, None]
    return _attn_out(p, mha(q, ck, cv, mask, cfg), cfg, shard)


def _attn_out(p: dict[str, Any], out: torch.Tensor, cfg: ModelConfig,
              shard: ShardFn) -> torch.Tensor:
    B, S = out.shape[:2]
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"].to(cfg.compute_dtype)
    return shard(out, ("batch", "seq", "embed"))


def _blocked_self_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, win: int) -> torch.Tensor:
    """Banded for sliding layers, full causal otherwise, both on the
    flash-attention kernel -> (B, S, Hq, D), differentiable in q, k and
    v."""
    if win and win < q.shape[1]:
        return banded_attention(q, k, v, win)
    return online_causal_attention(q, k, v)


# --------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------- #
def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``.  A DTensor table is looked up
    vocab-parallel: gathered along its FSDP dim, each rank looks the
    tokens up in its own vocab rows, zero where a token lies in another
    rank's rows, and the result is the ``Partial`` sum over the vocab's
    mesh dims (the next shard point reduces it)."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = table.device_mesh
    tp = [p if p == Shard(0) else Replicate() for p in table.placements]
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    kp = [p if p == Shard(0) and t != Shard(0) else Replicate()
          for p, t in zip(tokens.placements, tp)]
    table, tokens = table.redistribute(mesh, tp), tokens.redistribute(mesh, kp)
    # a rank's gradient of the table covers its own batch rows only: a
    # partial sum over the mesh dims that shard the tokens
    local = table.to_local(grad_placements=[
        Partial() if k == Shard(0) else t for t, k in zip(tp, kp)])
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, tp)
    rel = tokens.to_local().long() - offset[0]
    hit = (rel >= 0) & (rel < local.shape[0])
    rows = local[rel.clamp(0, local.shape[0] - 1)].masked_fill(
        ~hit[..., None], 0)
    out = [Partial() if t == Shard(0) else k for t, k in zip(tp, kp)]
    return DTensor.from_local(rows, mesh, out, run_check=False)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_type == "swiglu":
        return {
            "wi": dense_init(gen, d, ff, pd, device, lead),
            "wg": dense_init(gen, d, ff, pd, device, lead),
            "wo": dense_init(gen, ff, d, pd, device, lead),
        }
    return {
        "wi": dense_init(gen, d, ff, pd, device, lead),
        "wo": dense_init(gen, ff, d, pd, device, lead),
    }


def apply_mlp(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, shard: ShardFn = no_shard) -> torch.Tensor:
    cd = cfg.compute_dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"].to(cd)) * (x @ p["wi"].to(cd))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"].to(cd), approximate="tanh")
    h = shard(h, ("batch", "seq", "mlp"))
    return shard(h @ p["wo"].to(cd), ("batch", "seq", "embed"))


__all__ = [
    "apply_mlp", "apply_norm", "apply_rope", "attention", "attn_init",
    "causal_mask", "copy_into", "embed_rows", "init_kv_cache", "mha",
    "mlp_init", "norm_init", "rms_head_norm", "rope_freqs", "rope_tables",
    "sliding_mask",
]
