"""xLSTM blocks (arXiv:2405.04517) of the ``ssm`` family, xlstm-125m
(``repro/models/xlstm.py``): the mLSTM (matrix memory, chunkwise
parallel) and the sLSTM (scalar memory, strictly recurrent), mixed at
the paper's [7:1] ratio, and the LM over them with tied embeddings.

The mLSTM's chunkwise form is linear-attention-like: within a chunk of
L tokens an (L, L) decay-weighted score matrix, across chunks a
recurrent (C, n) carry, so a decode step costs O(1) whatever the
context, which is why this arch runs the ``long_500k`` cell.  Gating
follows the paper (exponential input gate, sigmoid forget gate in log
space), input-gate preactivations clipped at +-8 for stability.
``repro`` runs ``lax.scan`` over the chunks and over the sLSTM's tokens;
here both are Python loops with ``repro``'s per-step arithmetic, except
that the sLSTM forms its four input projections for every token at
once before the loop (the same sums, one product instead of 4 S).  All
of it is plain PyTorch, as ``repro`` computes it in jnp outside any
Pallas kernel.

One divergence, by design: ``repro`` forms the intra-chunk decay matrix
as ``where(tri, exp(logD), 0)``.  Above the diagonal ``logD`` sums up to
L - 1 forget-gate terms of about 0.7 each, so at L = 256 ``exp``
overflows to inf there; the forward never sees it, but the backward
multiplies it by 0 and gets NaN.  The port masks before the ``exp``
(``exp(logD.masked_fill(~tri, -inf))``): the same forward, bit for bit,
and a finite gradient.

Dtypes are ``repro``'s: the mLSTM state returns in the compute dtype
(bf16 in a served cache), the sLSTM state ``(h, c, n, m)`` stays f32.

``shard`` is ``repro``'s shard points: the residual stream after the
embedding and after each block, and the vocab-sharded logits.  Under a
mesh the projections run on DTensors, each weight gathered over its
FSDP dims (``common.py::weight``); the mLSTM's recurrence runs on each
rank's own batch rows and heads (``_mlstm_heads_local``) and the
sLSTM's token loop on its own batch rows (``_slstm_rows_local``), as
plain tensors.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

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
    apply_norm,
    embed_rows,
    norm_init,
)

_CLIP = 8.0


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
def mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(di, dh): the up-projected width and its per-head share."""
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    return di, di // cfg.n_heads


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device
               ) -> dict[str, torch.Tensor]:
    """``wq``/``wk``/``wv``/``wog`` (d, di), ``wi``/``wf`` (d, H),
    ``gn_scale`` (di,), ``wo`` (di, d)."""
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
    di, _ = mlstm_dims(cfg)
    return {
        "wq": dense_init(gen, d, di, pd, device),
        "wk": dense_init(gen, d, di, pd, device),
        "wv": dense_init(gen, d, di, pd, device),
        "wi": dense_init(gen, d, H, pd, device),
        "wf": dense_init(gen, d, H, pd, device),
        "wog": dense_init(gen, d, di, pd, device),
        "gn_scale": torch.ones((di,), dtype=pd, device=device),
        "wo": dense_init(gen, di, d, pd, device),
    }


def _head_groupnorm(x: torch.Tensor, scale: torch.Tensor, H: int
                    ) -> torch.Tensor:
    """Per-head RMS group norm over (B, S, H, dh) -> (B, S, H * dh)."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    B, S, _, dh = x.shape
    out = out.reshape(B, S, H * dh)
    if is_dtensor(out):
        # the gradient laid out as the merged heads are: the reshape's
        # backward cannot split a dim sharded over more ranks than heads
        out = out.redistribute(out.device_mesh, out.placements)
    return (out * scale.float()).to(x.dtype)


def _mlstm_chunk(qc, kc, vc, lic, lfc, C_in, n_in):
    """One chunk of L tokens from the carry ``(C_in (B, H, dh, dh),
    n_in (B, H, dh))``: qc/kc/vc (B, L, H, dh), lic/lfc (B, L, H) f32 ->
    (h (B, L, H, dh), C_out, n_out)."""
    L = qc.shape[1]
    Fc = torch.cumsum(lfc, dim=1)                           # (B, L, H)
    Ft = Fc.transpose(1, 2)
    # intra-chunk decay matrix (B, H, L, L), masked before the exp
    logD = Ft[:, :, :, None] - Ft[:, :, None, :] \
        + lic.transpose(1, 2)[:, :, None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    Dm = torch.exp(logD.masked_fill(~tri, float("-inf")))
    scores = torch.einsum("bshd,bthd->bhst", qc, kc) * Dm
    intra = torch.einsum("bhst,bthd->bshd", scores, vc)
    decay_in = torch.exp(Fc)                                # (B, L, H)
    inter = torch.einsum("bshd,bhdv->bshv", qc, C_in) * decay_in[..., None]
    # normalizer: n_t = exp(F_t) n_in + sum_{j <= t} D_tj k_j
    n_t = decay_in[..., None] * n_in[:, None] \
        + torch.einsum("bhst,bthd->bshd", Dm, kc)
    den = torch.einsum("bshd,bshd->bsh", n_t, qc).abs().clamp_min(1.0)
    h = (intra + inter) / den[..., None]
    # carry update
    w = torch.exp(Fc[:, -1:, :] - Fc + lic)                 # (B, L, H)
    last = torch.exp(Fc[:, -1])                             # (B, H)
    C_out = last[..., None, None] * C_in + torch.einsum(
        "blhk,blhv->bhkv", w[..., None] * kc, vc)
    n_out = last[..., None] * n_in + torch.einsum("blh,blhk->bhk", w, kc)
    return h, C_out, n_out


def _mlstm_scan(qf, kf, vf, logi, logf, state, L: int):
    """The mLSTM's recurrence over qf/kf/vf (B, S, H, dh) f32 and the
    gates' logi/logf (B, S, H) f32 from ``state`` = (C, n), zeros if
    None: one recurrent step for S = 1, else chunks of L tokens ->
    (h (B, S, H, dh), (C, n))."""
    B, S, H, dh = qf.shape
    if state is None:
        C = qf.new_zeros((B, H, dh, dh))
        n = qf.new_zeros((B, H, dh))
    else:
        C, n = state[0].float(), state[1].float()
    if S == 1:
        f = torch.exp(logf[:, 0])                           # (B, H)
        i = torch.exp(logi[:, 0])
        C = f[..., None, None] * C + i[..., None, None] * (
            kf[:, 0, :, :, None] * vf[:, 0, :, None, :])
        n = f[..., None] * n + i[..., None] * kf[:, 0]
        num = torch.einsum("bhkv,bhk->bhv", C, qf[:, 0])
        den = torch.einsum("bhk,bhk->bh", n, qf[:, 0]).abs().clamp_min(1.0)
        return (num / den[..., None])[:, None], (C, n)     # (B, 1, H, dh)
    hs = []
    for c in range(0, S, L):
        part = slice(c, c + L)
        h_c, C, n = _mlstm_chunk(qf[:, part], kf[:, part], vf[:, part],
                                 logi[:, part], logf[:, part], C, n)
        hs.append(h_c)
    return (hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)), (C, n)


def _mlstm_heads_local(qf, kf, vf, logi, logf, state, L: int):
    """``_mlstm_scan`` over DTensors, on each rank's own batch rows and
    heads: the recurrence is per (row, head), so a rank runs it on plain
    tensors.  On DTensors its einsums fold a sharded batch and sharded
    heads into one dim, which DTensor lays out as a strided shard and
    redistributes index by index.  Every input is cut to the rank's
    block (the gates, whole over the heads, by a local slice), so each
    block's gradient is whole on its rank; the outputs come back as
    DTensors laid out as q (h) and as the state (C, n)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = qf.device_mesh
    qp = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in qf.placements]
    sp = [Shard(1) if p == Shard(2) else p for p in qp]

    def local(x, want):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, want).to_local()

    if state is not None:
        state = tuple(local(t, sp) for t in state)
    h, (C, n) = _mlstm_scan(*(local(t, qp) for t in (qf, kf, vf, logi,
                                                    logf)), state, L)
    return (DTensor.from_local(h, mesh, qp, run_check=False),
            tuple(DTensor.from_local(t, mesh, sp, run_check=False)
                  for t in (C, n)))


def _logsigmoid(z: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, of each rank's shard (a
    ``Partial`` made whole first): DTensor has no rule for its
    backward."""
    if not is_dtensor(z):
        return F.logsigmoid(z)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = z.device_mesh
    want = [Replicate() if p.is_partial() else p for p in z.placements]
    z = z.redistribute(mesh, want)
    return DTensor.from_local(F.logsigmoid(z.to_local()), mesh, want,
                              run_check=False, shape=z.shape,
                              stride=z.stride())


def apply_mlstm(p: dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig,
                state: tuple[torch.Tensor, torch.Tensor] | None = None,
                shard: ShardFn = no_shard
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), state); ``state`` = (C (B, H, dh,
    dh), n (B, H, dh)), zeros if None, returned in the compute dtype.
    S = 1 is one recurrent step; otherwise chunks of L = min(chunk, S)
    tokens, S a multiple of L (``repro`` asserts it)."""
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    _, dh = mlstm_dims(cfg)

    def w(name: str, heads: tuple[int, int] | None = None) -> torch.Tensor:
        return weight(p[name], cd, shard, heads)

    q, k, v = ((x @ w(name, (1, H))).reshape(B, S, H, dh)
               for name in ("wq", "wk", "wv"))
    k = k / math.sqrt(float(dh))
    logi = torch.clamp((x @ w("wi")).float(), -_CLIP, _CLIP)
    logf = _logsigmoid((x @ w("wf")).float())
    og = torch.sigmoid(x @ w("wog"))
    L = S if S == 1 else min(cfg.xlstm.chunk, S)
    if S % L:
        raise ValueError(f"sequence of {S} is no multiple of the "
                         f"mLSTM chunk {L}")
    scan = _mlstm_heads_local if is_dtensor(q) else _mlstm_scan
    h, (C, n) = scan(q.float(), k.float(), v.float(), logi, logf, state, L)

    out = _head_groupnorm(h.to(cd), p["gn_scale"], H) * og
    return out @ w("wo"), (C.to(cd), n.to(cd))


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
GATES = ("i", "f", "z", "o")


def slstm_init(gen: torch.Generator, cfg: ModelConfig, device
               ) -> dict[str, torch.Tensor]:
    """Per gate g in i, f, z, o: ``wg`` (d, d) and the block-diagonal
    recurrent ``rg`` (H, dh, dh); the gated FFN's ``up`` (d, 2 ff) and
    ``down`` (ff, d), ff = max(4 d / 3, d); ``gn_scale`` (d,)."""
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
    dh = d // H
    p: dict[str, torch.Tensor] = {}
    for g in GATES:
        p[f"w{g}"] = dense_init(gen, d, d, pd, device)
        p[f"r{g}"] = (torch.randn((H, dh, dh), generator=gen,
                                  dtype=torch.float32, device=device)
                      / math.sqrt(dh)).to(pd)
    ff = max(int(4 * d / 3), d)
    p["up"] = dense_init(gen, d, 2 * ff, pd, device)
    p["down"] = dense_init(gen, ff, d, pd, device)
    p["gn_scale"] = torch.ones((d,), dtype=pd, device=device)
    return p


def apply_slstm(p: dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig,
                state: tuple[torch.Tensor, ...] | None = None,
                shard: ShardFn = no_shard
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """x (B, S, d) -> (out (B, S, d), state); ``state`` = (h, c, n, m),
    each (B, d) f32, zeros if None.  A recurrent loop over the S tokens,
    all in f32, then the group norm and the gated FFN in the compute
    dtype."""
    cd = cfg.compute_dtype
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    if state is None:
        state = tuple(x.new_zeros((B, d), dtype=torch.float32)
                      for _ in range(4))
    # every token's four input projections at once: (B, S, 4, d)
    w = torch.cat([p[f"w{g}"].float() for g in GATES], dim=1)
    xw = (x.float() @ w).reshape(B, S, 4, d)
    # the block-diagonal recurrent matrices, gates side by side
    r = torch.stack([p[f"r{g}"].float() for g in GATES], dim=1)  # H,4,dh,dh
    scan = _slstm_rows_local if is_dtensor(xw) else _slstm_scan
    hs, state = scan(xw, r, state, H)
    # group norm + gated FFN (xLSTM's post-up-projection)
    ms = (hs * hs).mean(dim=-1, keepdim=True)
    hs = (hs * torch.rsqrt(ms + 1e-6) * p["gn_scale"].float()).to(cd)
    ff = p["up"].shape[1] // 2
    u = hs @ weight(p["up"], cd, shard)
    hs = F.gelu(u[..., :ff], approximate="tanh") * u[..., ff:]
    return hs @ weight(p["down"], cd, shard), state


def _slstm_scan(xw: torch.Tensor, r: torch.Tensor,
                state: tuple[torch.Tensor, ...], H: int
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The sLSTM's recurrence over xw (B, S, 4, d), the input
    projections, with the recurrent matrices r (H, 4, dh, dh) from
    ``state`` -> (every token's h (B, S, d), the last state)."""
    B, S, _, d = xw.shape
    dh = d // H
    h, c, n, m = state
    hs = []
    for t in range(S):
        rec = torch.einsum("bhi,hgij->bghj", h.reshape(B, H, dh), r)
        it, ft, zt, ot = (xw[:, t] + rec.reshape(B, 4, d)).unbind(1)
        it = torch.clamp(it, -_CLIP, _CLIP)
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + m - m_new)
        c = f_g * c + i_g * torch.tanh(zt)
        n = f_g * n + i_g
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def _slstm_rows_local(xw, r, state, H: int):
    """``_slstm_scan`` over DTensors, on each rank's own batch rows: the
    recurrence is per row, so a rank runs the token loop on plain
    tensors (one op a step, not one DTensor dispatch) with the whole
    recurrent matrices, whose gradient is then partial over the batch's
    mesh dims.  The rows come back as DTensors laid out as xw's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xw.device_mesh
    R = Replicate()
    rp = [q if q == Shard(0) else R for q in xw.placements]
    xw = xw.redistribute(mesh, rp)
    if not is_dtensor(r):
        r = DTensor.from_local(r, mesh, [R] * mesh.ndim, run_check=False)
    r = r.redistribute(mesh, [R] * mesh.ndim).to_local(grad_placements=[
        Partial() if q == Shard(0) else R for q in rp])
    state = tuple(s.redistribute(mesh, rp).to_local() if is_dtensor(s)
                  else DTensor.from_local(s, mesh, [R] * mesh.ndim,
                                          run_check=False)
                  .redistribute(mesh, rp).to_local() for s in state)
    hs, state = _slstm_scan(xw.to_local(), r, state, H)
    return (DTensor.from_local(hs, mesh, rp, run_check=False),
            tuple(DTensor.from_local(s, mesh, rp, run_check=False)
                  for s in state))


# --------------------------------------------------------------------- #
# the xLSTM language model
# --------------------------------------------------------------------- #
def xlstm_block_kinds(cfg: ModelConfig) -> list[str]:
    xc = cfg.xlstm
    return ["slstm" if i % xc.slstm_every == xc.slstm_offset else "mlstm"
            for i in range(cfg.n_layers)]


def xlstm_lm_init(gen: torch.Generator, cfg: ModelConfig, device
                  ) -> dict[str, Any]:
    """``embed`` (V, d, tied with the head), ``layers`` a list of
    ``{"norm", "mlstm" | "slstm"}`` dicts, ``final_norm``."""
    layers = [{"norm": norm_init(cfg, device),
               kind: (mlstm_init if kind == "mlstm" else slstm_init)(
                   gen, cfg, device)}
              for kind in xlstm_block_kinds(cfg)]
    return {"embed": embed_init(gen, cfg.vocab, cfg.d_model,
                                cfg.param_dtype, device),
            "layers": layers,
            "final_norm": norm_init(cfg, device)}


def init_xlstm_states(cfg: ModelConfig, batch: int, device) -> list[Any]:
    """Zero per-layer states: an mLSTM's (C, n) in the compute dtype, an
    sLSTM's (h, c, n, m) in f32."""
    _, dh = mlstm_dims(cfg)
    H, d = cfg.n_heads, cfg.d_model

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return [(zeros((batch, H, dh, dh), cfg.compute_dtype),
             zeros((batch, H, dh), cfg.compute_dtype)) if kind == "mlstm"
            else tuple(zeros((batch, d), torch.float32) for _ in range(4))
            for kind in xlstm_block_kinds(cfg)]


def xlstm_hidden(params: dict[str, Any], tokens: torch.Tensor,
                 cfg: ModelConfig, state: list[Any] | None = None,
                 shard: ShardFn = no_shard
                 ) -> tuple[torch.Tensor, list[Any]]:
    """tokens (B, S) -> (the final-normed hidden state (B, S, d), the
    new per-layer states); ``state`` is None on a first call.
    ``shard`` is ``repro``'s shard points on the residual stream (the
    embeddings and each block's output)."""
    x = shard(embed_rows(params["embed"], tokens).to(cfg.compute_dtype),
              ("batch", "seq", "embed"))
    new_states: list[Any] = []
    for i, (kind, blk) in enumerate(zip(xlstm_block_kinds(cfg),
                                        params["layers"])):
        st = state[i] if state is not None else None
        normed = apply_norm(blk["norm"], x, cfg)
        apply = apply_mlstm if kind == "mlstm" else apply_slstm
        out, st = apply(blk[kind], normed, cfg, st, shard)
        x = shard(x + out, ("batch", "seq", "embed"))
        new_states.append(st)
    return apply_norm(params["final_norm"], x, cfg), new_states


def xlstm_lm_apply(params: dict[str, Any], tokens: torch.Tensor,
                   cfg: ModelConfig, state: list[Any] | None = None,
                   shard: ShardFn = no_shard
                   ) -> tuple[torch.Tensor, list[Any]]:
    """tokens (B, S) -> (logits (B, S, V) in the compute dtype, the new
    per-layer states); the logits sharded over ``vocab``."""
    x, states = xlstm_hidden(params, tokens, cfg, state, shard)
    return shard(x @ weight(params["embed"], cfg.compute_dtype, shard).T,
                 ("batch", "seq", "vocab")), states


__all__ = ["apply_mlstm", "apply_slstm", "init_xlstm_states",
           "mlstm_dims", "mlstm_init", "slstm_init", "xlstm_block_kinds",
           "xlstm_hidden", "xlstm_lm_apply", "xlstm_lm_init"]
