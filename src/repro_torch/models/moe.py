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

Under a mesh (x a DTensor) each rank routes its own groups and runs its
own experts (``_moe_on_mesh``): the expert dim over the mesh axes
``repro``'s ``"expert"`` rule gives it, the groups over the batch's.
When E does not divide the model axis the expert dim is replicated, as
``repro``'s ``resolve`` drops the axis; no shard point of ``repro``
names its ``"capacity"`` rule, so nothing shards the slots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    ShardFn,
    dense_init,
    is_dtensor,
    no_shard,
)


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


def _experts(w: dict[str, torch.Tensor], x: torch.Tensor,
             slot: torch.Tensor, gates: torch.Tensor, keep: torch.Tensor,
             cfg: ModelConfig, C: int, e0: int = 0) -> torch.Tensor:
    """Dispatch, the experts' FFN and the combine over the experts ``e0
    .. e0 + El - 1`` that ``w``'s leaves hold (El their leading dim):
    x (B, S, d) and its routing -> (B, S, d), the gated sum of the
    (token, k) pairs those experts took.  A pair routed to another
    expert, or past its expert's capacity, adds nothing."""
    B, S, d = x.shape
    K = cfg.moe.top_k
    cd = cfg.compute_dtype
    El = w["wi"].shape[0]

    # dispatch into one (El, B*C, d) buffer, expert-major, so that the
    # experts' products are batched matmuls over El with no permute: a
    # group's slot e*C + c is row (e - e0)*(B*C) + b*C + c, its drop row
    # the extra row El*B*C.  Each kept (token, k) has a row of its own;
    # only the drop row is written twice, and it is cut off, so the
    # order of those writes never reaches the result (nor the
    # gradient: the backward gathers each row's gradient, as ``repro``'s
    # scatter-add gathers its cotangent)
    rows = El * B * C
    e = slot // C - e0
    mine = keep & (e >= 0) & (e < El)
    group = torch.arange(B, device=x.device)[:, None]
    flat_slot = torch.where(mine, e * (B * C) + group * C + slot % C,
                            rows).reshape(-1)
    xk = x.repeat_interleave(K, dim=1).to(cd)   # row i*K+k: token i copy k
    buf = torch.zeros((rows + 1, d), dtype=cd, device=x.device).index_put(
        (flat_slot,), xk.reshape(-1, d))
    buf = buf[:rows].view(El, B * C, d)

    # the experts' FFN, batched over experts
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(buf, w["wg"].to(cd)))
        h = h * torch.bmm(buf, w["wi"].to(cd))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(buf, w["wi"].to(cd)), approximate="tanh")
    out_e = torch.bmm(h, w["wo"].to(cd))                      # (El, B*C, d)

    # combine: each (token, k)'s slot output (the drop row reads zeros),
    # weighted by its gate
    flat = torch.cat([out_e.reshape(rows, d),
                      torch.zeros((1, d), dtype=cd, device=x.device)])
    gathered = flat[flat_slot].reshape(B, S * K, d)
    wt = (gates * mine).to(cd)
    return (gathered * wt[..., None]).reshape(B, S, K, d).sum(dim=2)


def _capacity(cfg: ModelConfig, S: int) -> int:
    mc = cfg.moe
    return max(1, int(S * mc.top_k * mc.capacity_factor / mc.num_experts))


def apply_moe(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, shard: ShardFn = no_shard
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, a 0-dim f32).  B is the
    routing group dim.  Under a mesh (x a DTensor) ``_moe_on_mesh``."""
    if is_dtensor(x):
        return _moe_on_mesh(p, x, cfg, shard)
    C = _capacity(cfg, x.shape[1])
    slot, gates, keep, aux = _route_group(x, p["router"], cfg, C)
    experts = {k: p[k] for k in ("wi", "wg", "wo") if k in p}
    return _experts(experts, x, slot, gates, keep, cfg, C), aux.mean()


def _moe_on_mesh(p: dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, shard: ShardFn
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``repro``'s three shard points, ``("batch", "expert", None,
    "embed" | "mlp")`` on its (B, E, C, d) dispatch buffer, on each
    rank's own routing groups and experts.  The expert dim's mesh dims
    are those ``resolve`` gives ``"expert"`` (none when E does not
    divide their extent: every rank then runs every expert); the
    groups are x's batch shards, whole sequences (B is the group dim, so
    a batch shard holds whole groups).  Each rank routes its groups with
    the whole router, dispatches the pairs that chose its experts into a
    local (El, B_l*C, d) buffer, the port's expert-major layout of its
    block of ``repro``'s, runs them and combines; the outputs are summed
    over the expert dims (a ``Partial`` made whole).  What a rank reads
    only in part gets a partial gradient: the weights over the batch
    dims (its own groups), x and the gates over the expert dims (its own
    experts)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    from repro_torch.distributed.sharding import placements, resolve

    mesh = x.device_mesh
    nd = mesh.ndim
    B, S, d = x.shape
    E = cfg.moe.num_experts
    C = _capacity(cfg, S)
    R = Replicate()
    xp = [q if q == Shard(0) else R for q in x.placements]
    x = x.redistribute(mesh, xp)
    bd = {i for i, q in enumerate(xp) if q == Shard(0)}
    spec = resolve(mesh, (B, E, C, d), ("batch", "expert", None, "embed"),
                   shard.rules)
    ex = {i for i, q in enumerate(placements(spec, mesh))
          if q == Shard(1) and i not in bd}

    def whole(t: torch.Tensor) -> torch.Tensor:
        if not is_dtensor(t):
            return DTensor.from_local(t, mesh, [R] * nd, run_check=False)
        return t

    def grad(i: int, q):
        return Partial() if i in bd else q

    router = whole(p["router"]).redistribute(mesh, [R] * nd).to_local(
        grad_placements=[grad(i, R) for i in range(nd)])
    want = [Shard(0) if i in ex else R for i in range(nd)]
    experts = {k: whole(p[k]).redistribute(mesh, want).to_local(
        grad_placements=[grad(i, q) for i, q in enumerate(want)])
        for k in ("wi", "wg", "wo") if k in p}
    _, offset = compute_local_shape_and_global_offset(
        p["wi"].shape, mesh, want)

    xl = x.to_local()
    slot, gates, keep, aux = _route_group(xl, router, cfg, C)
    if ex:
        # the combine reads the gates and x of this rank's experts only
        part = [Partial() if i in ex else q for i, q in enumerate(xp)]
        gates = DTensor.from_local(gates, mesh, xp, run_check=False
                                   ).to_local(grad_placements=part)
        xl = x.to_local(grad_placements=part)
    out = _experts(experts, xl, slot, gates, keep, cfg, C, e0=offset[0])
    out = DTensor.from_local(
        out, mesh, [Partial() if i in ex else q for i, q in enumerate(xp)],
        run_check=False).redistribute(mesh, xp)
    aux = DTensor.from_local(aux, mesh, xp, run_check=False).mean()
    return out, aux.redistribute(mesh, [R] * nd)


__all__ = ["apply_moe", "moe_init"]
