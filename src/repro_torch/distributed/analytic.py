"""Analytic FLOP and byte model per arch x shape cell
(``repro/distributed/analytic.py``), on the port's ``ModelConfig`` and
``ShapeSpec``: the same numbers as the JAX package's for every arch and
cell, train steps as ``repro``'s at ``remat="none"``.

On the card these are what a model path is held against:
``chip_smoke.py`` prints each model row's ``cell_cost`` FLOPs and bytes
and its bound, the larger of FLOPs over the bf16 peak and bytes over the
memory rate.  The tests cross-check ``fwd_flops`` against
``torch.utils.flop_counter.FlopCounterMode`` on the port's forward
(``repro``'s ``xla_cost_dict``, which reads XLA's compiled cost
analysis, has no counterpart here).

Conventions:
  * matmul (m,k)x(k,n): 2*m*k*n flops
  * train = fwd + bwd (2x fwd).  The port does not rematerialise (its
    ``ModelConfig`` has no ``remat``), so there is no recompute term:
    ``repro``'s default ``remat="full"`` adds 1x fwd for the recompute
    XLA does there.
  * causal attention scores: 0.5 * S^2 visible pairs (windowed: S*W)
  * bytes: per-device HBM traffic model (weights, activations, cache,
    optimizer), coarse but consistent across cells.  It leaves out
    traffic the port does beside it: e.g. the serve steps' f32 -> bf16
    weight casts, and score tiles of the blocked path (counted as kept
    on chip).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.api import ShapeSpec
from repro_torch.models.common import ModelConfig
from repro_torch.models.xlstm import xlstm_block_kinds


@dataclasses.dataclass
class CostBreakdown:
    flops_global: float
    bytes_per_device: float
    details: dict[str, float]


def _attn_pairs(S_q: int, S_kv: int, window: int, causal: bool = True) -> float:
    """Visible (q, kv) pairs per head per sequence."""
    if window and window < S_kv:
        return float(S_q) * window
    if causal and S_q == S_kv:
        return 0.5 * S_q * S_kv
    return float(S_q) * S_kv


def layer_linear_flops_per_token(cfg: ModelConfig) -> float:
    """fwd flops/token in the per-layer matmuls (no attention quadratic)."""
    d, ff = cfg.d_model, cfg.d_ff
    f = 2.0 * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2.0 * cfg.q_dim * d  # qkvo
    if cfg.moe is not None:
        n_mats = 3 if cfg.mlp_type == "swiglu" else 2
        f += 2.0 * d * cfg.moe.num_experts                      # router
        f += cfg.moe.top_k * n_mats * 2.0 * d * ff              # experts
    elif ff > 0:
        n_mats = 3 if cfg.mlp_type == "swiglu" else 2
        f += n_mats * 2.0 * d * ff
    if cfg.ssm is not None:
        sc = cfg.ssm
        di, n = sc.expand * d, sc.state_dim
        f += 2.0 * d * 2 * di + 2.0 * di * d                    # in/out proj
        f += 2.0 * di * (2 * n + 1) + 2 * sc.conv_width * di    # B,C,dt,conv
        f += 10.0 * di * n                                      # scan update
    return f


def _xlstm_flops_per_token(cfg: ModelConfig, chunk: int) -> float:
    """fwd flops/token across the xLSTM stack."""
    d = cfg.d_model
    H = cfg.n_heads
    total = 0.0
    for kind in xlstm_block_kinds(cfg):
        if kind == "mlstm":
            di = int(cfg.xlstm.proj_factor * d)
            dh = di // H
            f = 2.0 * d * di * 4 + 2.0 * di * d      # q,k,v,og + out
            f += 2.0 * d * H * 2                     # i,f gates
            # chunkwise: intra (L_c pairs/2) + inter/carry (dh^2 state)
            f += 4.0 * H * (chunk / 2) * dh          # intra scores+out /token
            f += 6.0 * H * dh * dh                   # q@C, carry update
            total += f
        else:
            dh = d // H
            f = 4 * (2.0 * d * d + 2.0 * d * dh)     # 4 gates: W + blockdiag R
            ffi = max(int(4 * d / 3), d)
            f += 2.0 * d * 2 * ffi + 2.0 * ffi * d   # up/down
            total += f
    total += 2.0 * d * cfg.vocab                     # tied lm head
    return total


def fwd_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, float]:
    """Global forward flops by component for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    out: dict[str, float] = {}
    if shape.kind == "decode":
        S_q, S_kv = 1, S
    else:
        S_q, S_kv = S, S

    if cfg.family == "ssm":
        T = B * S_q
        out["stack"] = T * _xlstm_flops_per_token(cfg, cfg.xlstm.chunk)
        return out

    T = B * S_q
    lin = layer_linear_flops_per_token(cfg)
    out["linear"] = T * lin * cfg.n_layers

    # attention quadratic: 4 flops per COMPUTED pair per head-dim channel.
    # The dense path computes full scores and then masks (sliding windows
    # do not save flops); the windowed ring cache (decode) and the
    # blocked path's band shrink the computed pairs.
    win = cfg.window if cfg.attn_type == "sliding" else 0
    n_global = len(cfg.global_attn_layers)
    n_sliding = cfg.n_layers - n_global if win else 0
    pairs_full = _attn_pairs(S_q, S_kv, 0)
    if win and shape.kind == "decode" and cfg.windowed_cache and not cfg.global_attn_layers:
        pairs_win = _attn_pairs(S_q, min(S_kv, win), 0, causal=False)
    elif win and cfg.attn_impl == "blocked" and shape.kind != "decode":
        # banded path computes only the band
        pairs_win = _attn_pairs(S_q, S_kv, win)
    else:
        pairs_win = pairs_full
    attn = 4.0 * cfg.n_heads * cfg.hd * B * (
        (cfg.n_layers - n_sliding) * pairs_full + n_sliding * pairs_win
    )
    out["attention"] = attn

    if cfg.family == "encdec":
        Te = B * cfg.enc_seq
        out["encoder"] = Te * (
            2.0 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
            + 2.0 * cfg.q_dim * cfg.d_model
            + 2 * 2.0 * cfg.d_model * cfg.d_ff
        ) * cfg.enc_layers if shape.kind != "decode" else 0.0
        out["enc_attention"] = (
            4.0 * cfg.n_heads * cfg.hd * B * cfg.enc_seq**2 * cfg.enc_layers
            if shape.kind != "decode" else 0.0
        )
        # the decoder's cross block: q/o projections, the encoder's K/V
        # projections once a prefill, scores over enc_seq
        out["cross"] = cfg.n_layers * (
            T * (2.0 * cfg.d_model * cfg.q_dim + 2.0 * cfg.q_dim * cfg.d_model)
            + (B * (2.0 * cfg.enc_seq * cfg.d_model * 2 * cfg.kv_dim / max(B,1))
               if shape.kind != "decode" else 0.0)
            + 4.0 * cfg.n_heads * cfg.hd * B * S_q * cfg.enc_seq
        )

    out["lm_head"] = 2.0 * T * cfg.d_model * cfg.vocab
    return out


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, n_devices: int
              ) -> CostBreakdown:
    """Analytic flops (global) + bytes (per device) for one step."""
    B, S = shape.global_batch, shape.seq_len
    comps = fwd_flops(cfg, shape)
    fwd = float(sum(comps.values()))
    # train: fwd + bwd (2x); no remat recompute (module docstring)
    flops = fwd * 3.0 if shape.kind == "train" else fwd

    # ---------------- bytes per device ------------------------------ #
    # parameter bytes (sharded over all axes for fsdp+tp layouts)
    pbytes = param_bytes(cfg)
    p_local = pbytes / n_devices
    tok_local = B * (S if shape.kind != "decode" else 1) / max(
        _batch_shards(n_devices), 1
    )
    act_b = 2.0  # bf16

    details = dict(comps)
    if shape.kind == "train":
        # weights: fwd read + 2x bwd read + grad write + opt (read p,m,v;
        # write p,m,v) => ~10 passes over local params
        w_traffic = 10.0 * p_local
        # activations: ~12 tensor r/w per layer + scores r/w (non-flash)
        act_traffic = (
            12.0 * tok_local * cfg.d_model * act_b * max(cfg.n_layers, 1) * 2
        )
        pairs = _attn_pairs(S, S, 0) * B / max(_batch_shards(n_devices), 1)
        score_traffic = 4.0 * cfg.n_heads * pairs * 4.0  # f32 scores r/w, fwd+bwd
        if cfg.family == "ssm":
            score_traffic = 0.0
        if cfg.attn_impl == "blocked":
            score_traffic = 0.0  # tiles stay on chip
        bytes_dev = w_traffic + act_traffic + score_traffic
        details.update(w_traffic=w_traffic, act_traffic=act_traffic,
                       score_traffic=score_traffic)
    elif shape.kind == "prefill":
        w_traffic = p_local
        act_traffic = 8.0 * tok_local * cfg.d_model * act_b * cfg.n_layers
        cache_w = cache_bytes(cfg, shape) / n_devices
        bytes_dev = w_traffic + act_traffic + cache_w
        details.update(w_traffic=w_traffic, act_traffic=act_traffic,
                       cache_traffic=cache_w)
    else:  # decode: params + full cache read per token
        w_traffic = p_local
        cache_r = cache_bytes(cfg, shape) / n_devices
        bytes_dev = w_traffic + cache_r
        details.update(w_traffic=w_traffic, cache_traffic=cache_r)

    return CostBreakdown(
        flops_global=flops, bytes_per_device=float(bytes_dev), details=details
    )


def _batch_shards(n_devices: int) -> int:
    # batch shards under baseline rules: the (pod, data) extent
    return {256: 16, 512: 32}.get(n_devices, max(n_devices // 16, 1))


def param_bytes(cfg: ModelConfig) -> float:
    """Total parameter bytes (from config math; f32 params)."""
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    per_layer = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    if cfg.moe is not None:
        n_mats = 3 if cfg.mlp_type == "swiglu" else 2
        per_layer += d * cfg.moe.num_experts + cfg.moe.num_experts * n_mats * d * ff
    elif ff > 0:
        n_mats = 3 if cfg.mlp_type == "swiglu" else 2
        per_layer += n_mats * d * ff
    if cfg.ssm is not None:
        di = cfg.ssm.expand * d
        per_layer += d * 2 * di + di * d + di * (2 * cfg.ssm.state_dim + 1)
    total = L * per_layer + V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        total = V * d
        for kind in xlstm_block_kinds(cfg):
            if kind == "mlstm":
                di = int(cfg.xlstm.proj_factor * d)
                total += 4 * d * di + di * d + 2 * d * cfg.n_heads
            else:
                ffi = max(int(4 * d / 3), d)
                total += 4 * (d * d + d * (d // cfg.n_heads)) + 3 * d * ffi
    if cfg.family == "encdec":
        enc_layer = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + 2 * d * ff
        cross = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
        total += cfg.enc_layers * enc_layer + L * cross + cfg.max_seq * d
    return total * 4.0  # f32


def cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global KV/SSM cache bytes at this cell's context length."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        total = 0.0
        for kind in xlstm_block_kinds(cfg):
            if kind == "mlstm":
                di = int(cfg.xlstm.proj_factor * cfg.d_model)
                dh = di // cfg.n_heads
                total += B * cfg.n_heads * dh * (dh + 1) * 2
            else:
                total += 4 * B * cfg.d_model * 4
        return total
    L_cache = S
    if cfg.windowed_cache and cfg.attn_type == "sliding" and not cfg.global_attn_layers:
        L_cache = min(S, cfg.window)
    bytes_per_entry = 2.0
    if cfg.kv_cache_dtype == "int8":
        bytes_per_entry = 1.0 + 4.0 / cfg.hd  # int8 + per-row f32 scale
    kv = cfg.n_layers * B * L_cache * cfg.kv_dim * 2 * bytes_per_entry
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        kv += cfg.n_layers * B * di * (cfg.ssm.state_dim + cfg.ssm.conv_width - 1) * 2
    if cfg.family == "encdec":
        kv += cfg.n_layers * B * cfg.enc_seq * cfg.kv_dim * 2 * 2
    return kv


__all__ = [
    "CostBreakdown", "cache_bytes", "cell_cost", "fwd_flops",
    "layer_linear_flops_per_token", "param_bytes",
]
