"""Selective SSM (Mamba-style) branch of the hybrid architecture, hymba
(``repro/models/ssm.py``).

Train and prefill scan ``h_t = a_t h_{t-1} + b_t`` in chunks of
``cfg.ssm.chunk`` tokens; decode carries an ``(h, conv_tail)`` state,
O(1) a token, which is what lets the hybrid run the ``long_500k`` cell.
``repro`` runs ``lax.scan`` over the chunks with an
``lax.associative_scan`` inside each; eager PyTorch has neither, and a
loop over tokens would be S steps a layer.  So ``_chunked_scan`` forms
every chunk's in-chunk prefixes at once by a log-depth (Hillis-Steele)
scan over the chunk axis, with ``repro``'s combine, then carries ``h``
across the S / chunk chunks one small step each, as ``lax.scan`` does.
The f32 products are associated in another order than XLA's, so the
results agree in the last bits of f32 only.  ``repro`` computes all of
it in jnp, outside any Pallas kernel, so it is plain PyTorch here too.

Under a mesh the branch runs on DTensors between ``repro``'s two shard
points: d_inner over ``mlp`` and the output.  The scan is per channel,
so a model-sharded d_inner needs no collective inside it; the chunk
reshapes and the doubling's shifts run along ``seq``, which no rule of
these shards.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    dense_init,
    no_shard,
    weight,
)


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device,
             lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """The branch's weights behind ``lead``, in ``repro``'s layout:
    ``in_proj`` (d, 2 di), ``conv`` (W, di), ``A_log`` (di, n),
    ``B_proj``/``C_proj`` (di, n), ``dt_proj`` (di, 1), ``D`` (di,),
    ``out_proj`` (di, d)."""
    sc, d, pd = cfg.ssm, cfg.d_model, cfg.param_dtype
    di, n = sc.expand * d, sc.state_dim
    conv = torch.randn(lead + (sc.conv_width, di), generator=gen,
                       dtype=torch.float32, device=device) * 0.1
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(gen, d, 2 * di, pd, device, lead),
        "conv": conv.to(pd),
        "A_log": a_log.expand(lead + (di, n)).contiguous().to(pd),
        "B_proj": dense_init(gen, di, n, pd, device, lead),
        "C_proj": dense_init(gen, di, n, pd, device, lead),
        "dt_proj": dense_init(gen, di, 1, pd, device, lead),
        "D": torch.ones(lead + (di,), dtype=pd, device=device),
        "out_proj": dense_init(gen, di, d, pd, device, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, di), w: (W, di), tail: (B, W-1,
    di) of the inputs before x (zeros if None) -> (out (B, S, di), the
    new tail)."""
    W, S = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return out, new_tail


def _chunk_prefixes(a: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefixes along dim 2 of ``(a, b)`` under ``repro``'s
    combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, by
    Hillis-Steele doubling: log2(L) rounds over all chunks at once."""
    L = a.shape[2]
    step = 1
    while step < L:
        a_prev, b_prev = a[:, :, :-step], b[:, :, :-step]
        a_cur, b_cur = a[:, :, step:], b[:, :, step:]
        a = torch.cat([a[:, :, :step], a_prev * a_cur], dim=2)
        b = torch.cat([b[:, :, :step], torch.addcmul(b_cur, a_cur, b_prev)],
                      dim=2)
        step *= 2
    return a, b


def _chunked_scan(h0: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` from ``h0`` (B, di, n) over a, b (B, S,
    di, n), S a multiple of ``chunk`` -> (h_seq (B, S, di, n), h_last)."""
    B, S, di, n = a.shape
    nc = S // chunk
    a_c, b_c = _chunk_prefixes(a.reshape(B, nc, chunk, di, n),
                               b.reshape(B, nc, chunk, di, n))
    h, starts = h0, []
    for c in range(nc):
        starts.append(h)
        h = torch.addcmul(b_c[:, c, -1], a_c[:, c, -1], h)
    h_seq = torch.addcmul(b_c, a_c, torch.stack(starts, dim=1)[:, :, None])
    return h_seq.reshape(B, S, di, n), h


def apply_ssm(p: dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              state: tuple[torch.Tensor, torch.Tensor] | None = None,
              shard: ShardFn = no_shard
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """x: (B, S, d); ``state`` = (h (B, di, n), conv_tail (B, W-1, di))
    of the tokens before x, zeros if None -> (out (B, S, d), new state
    in the compute dtype).  S == 1 is the decode step; S > 1 must be a
    multiple of ``min(cfg.ssm.chunk, S)``.  ``shard`` is ``repro``'s two
    shard points: the conv's output over ``mlp`` (d_inner) and the
    branch's output."""
    sc = cfg.ssm
    cd = cfg.compute_dtype
    B, S, d = x.shape
    di, n = sc.expand * d, sc.state_dim

    xz = x @ weight(p["in_proj"], cd, shard)
    xs, z = xz[..., :di], xz[..., di:]
    tail = state[1] if state is not None else None
    xs, new_tail = _causal_conv(xs, p["conv"].to(cd), tail)
    xs = shard(F.silu(xs), ("batch", "seq", "mlp"))

    # jax.nn.softplus is logaddexp(x, 0); torch's softplus is x itself
    # past its threshold
    dt = xs @ p["dt_proj"].to(cd)
    dt = torch.logaddexp(dt, dt.new_zeros(()))                  # (B, S, 1)
    Bm = xs @ p["B_proj"].to(cd)                                # (B, S, n)
    Cm = xs @ p["C_proj"].to(cd)                                # (B, S, n)
    A = -torch.exp(p["A_log"].float())                          # (di, n)

    # discretize: a = exp(dt A); b = dt B (x) x, both f32
    dtf = dt.float()
    a = torch.exp(dtf[..., None] * A)                           # (B,S,di,n)
    b = (dtf * xs.float())[..., None] * Bm.float()[:, :, None, :]
    h0 = (state[0].float() if state is not None
          else torch.zeros((B, di, n), dtype=torch.float32, device=x.device))

    if S == 1:
        h_last = a[:, 0] * h0 + b[:, 0]                         # (B, di, n)
        y = torch.einsum("bdn,bn->bd", h_last, Cm[:, 0].float())[:, None]
    else:
        chunk = min(sc.chunk, S)
        if S % chunk:
            raise ValueError(f"SSM scan: sequence {S} is no multiple of "
                             f"its chunk {chunk}")
        h_all, h_last = _chunked_scan(h0, a, b, chunk)
        y = torch.einsum("bsdn,bsn->bsd", h_all, Cm.float())

    y = y.to(cd) + xs * p["D"].to(cd)
    y = y * F.silu(z)
    out = y @ weight(p["out_proj"], cd, shard)
    return shard(out, ("batch", "seq", "embed")), (h_last.to(cd), new_tail)


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero ``(h (layers, B, di, n), conv_tail (layers, B, W-1, di))`` in
    the compute dtype, the cache's ``ssm_h`` and ``ssm_tail``."""
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    cd = cfg.compute_dtype
    return (
        torch.zeros((layers, batch, di, sc.state_dim), dtype=cd,
                    device=device),
        torch.zeros((layers, batch, sc.conv_width - 1, di), dtype=cd,
                    device=device),
    )


__all__ = ["apply_ssm", "init_ssm_state", "ssm_init"]
