"""Mixture-of-Experts FFN with top-k capacity routing, dbrx and granite
(``repro/models/moe.py``).

GShard-style grouped dispatch: the batch dimension is the routing
group, so positions and capacity are counted per group.  Every group is
a tensor dim here, as ``repro`` vmaps over them.  ``repro``'s dispatch
buffer is ``(B, E, C, d)``; here it is laid out ``(E, B*C, d)``, the same
rows, so the experts run as one batched matmul.  A (token, k) pair past
its expert's capacity C goes to a drop row and adds nothing.  ``repro``
computes all of it in jnp, outside any Pallas kernel, so it is plain
PyTorch here too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, device,
             lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """``router`` (d, E) and the experts' ``wi``, ``wo`` (and ``wg`` for
    swiglu), each (E, d_in, d_out), behind ``lead``."""
    E = cfg.moe.num_experts
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    experts = lead + (E,)
    p = {
        "router": dense_init(gen, d, E, pd, device, lead),
        "wi": dense_init(gen, d, ff, pd, device, experts),
        "wo": dense_init(gen, ff, d, pd, device, experts),
    }
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense_init(gen, d, ff, pd, device, experts)
    return p


def _route_group(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
                 C: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Routing of each group. xt: (B, T, d) -> (slot (B, T*K), gates
    (B, T*K), keep (B, T*K), aux (B,)); row ``i*K + k`` is token i's
    k-th choice.

    ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities; a stable descending sort does the same (``torch.topk``
    promises no order), so a tie routes as in ``repro``."""
    mc = cfg.moe
    B, T, _ = xt.shape
    E, K = mc.num_experts, mc.top_k
    logits = xt.float() @ router.float()                       # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :K]
    expert_ids = order.indices[..., :K]                        # (B, T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    density = F.one_hot(expert_ids[..., 0], E).float().mean(dim=1)
    density_proxy = probs.mean(dim=1)
    aux = (density * density_proxy).sum(dim=-1) * E * mc.router_aux_weight

    # position of each (token, k) among its expert's picks, in
    # token-major order: the count of earlier rows that chose it.  The
    # one-hot is laid out (B, E, T*K) so that the count is a scan along
    # the innermost dim (a scan along an outer dim of extent T*K runs
    # one thread a column on CUDA: 12 ms a granite layer at B=4, S=4096)
    eid = expert_ids.reshape(B, T * K)
    experts = torch.arange(E, device=xt.device, dtype=eid.dtype)
    onehot = (eid[:, None, :] == experts[None, :, None]).to(torch.int32)
    counts = onehot.cumsum(dim=-1, dtype=torch.int32)          # (B, E, T*K)
    pos = counts.gather(1, eid[:, None, :])[:, 0].long() - 1
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    return slot, gate_vals.reshape(B, T * K), keep, aux


def apply_moe(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, a 0-dim f32).  B is the
    routing group dim."""
    mc = cfg.moe
    B, S, d = x.shape
    E, K = mc.num_experts, mc.top_k
    cd = cfg.compute_dtype
    C = max(1, int(S * K * mc.capacity_factor / E))

    slot, gates, keep, aux = _route_group(x, p["router"], cfg, C)

    # dispatch into one (E, B*C, d) buffer, expert-major, so that the
    # experts' products are batched matmuls over E with no permute: a
    # group's slot e*C + c is row e*(B*C) + b*C + c, its drop row E*C
    # the extra row E*B*C.  Each kept (token, k) has a row of its own;
    # only the drop row is written twice, and it is cut off, so the
    # order of those writes never reaches the result (nor the
    # gradient: the backward gathers each row's gradient, as ``repro``'s
    # scatter-add gathers its cotangent)
    rows = E * B * C
    group = torch.arange(B, device=x.device)[:, None]
    flat_slot = torch.where(keep, (slot // C) * (B * C) + group * C
                            + slot % C, rows).reshape(-1)
    xk = x.repeat_interleave(K, dim=1).to(cd)   # row i*K+k: token i copy k
    buf = torch.zeros((rows + 1, d), dtype=cd, device=x.device).index_put(
        (flat_slot,), xk.reshape(-1, d))
    buf = buf[:rows].view(E, B * C, d)

    # the experts' FFN, batched over experts
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(buf, p["wg"].to(cd)))
        h = h * torch.bmm(buf, p["wi"].to(cd))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(buf, p["wi"].to(cd)), approximate="tanh")
    out_e = torch.bmm(h, p["wo"].to(cd))                       # (E, B*C, d)

    # combine: each (token, k)'s slot output (the drop row reads zeros),
    # weighted by its gate
    flat = torch.cat([out_e.reshape(rows, d),
                      torch.zeros((1, d), dtype=cd, device=x.device)])
    gathered = flat[flat_slot].reshape(B, S * K, d)
    w = (gates * keep).to(cd)
    out = (gathered * w[..., None]).reshape(B, S, K, d).sum(dim=2)
    return out, aux.mean()


__all__ = ["apply_moe", "moe_init"]
