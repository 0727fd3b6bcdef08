"""KV-cached transformer policy on the pool's hot loop
(``repro/rl/policy_lm.py``).

The policy is a decoder-only transformer; every ``recv`` decodes
exactly ONE token per served lane against a persistent per-lane KV
cache.  The cache is policy lane state: ``LMLaneState`` holds one
static-shape cache row per env lane, lane-major (every leaf leads with
``num_envs``), gathered and scattered by the served block's ``env_id``
like the pool's own per-lane state.  A finished lane's next serve
restarts at ``length = 0``, which turns the scheduler's top-M selection
into continuous batching.

Two forward paths share one parameter dict (``models/transformer.py``
layout plus a ``value_head``):

* ``decode_step`` — the hot path: one token per lane, ragged per-lane
  ``lengths``, attention through the ``decode_attention`` kernel, K/V
  written at each lane's own position;
* ``full_forward`` — the baseline: the no-cache ``lm_apply`` over each
  lane's token history every step.  Causal masking makes the padded
  tail harmless, so both emit the same distribution.

Where the JAX package is functional, this port writes in place to save
memory, as the JAX package's donated buffers let XLA do: ``decode_step``
writes the new K/V rows into the caches it is given (a qwen3-0.6b cache
of 32 lanes x 161 positions is 0.6 GB), and ``act``/``act_full`` write
the served block back into ``lanes``' tensors.  A caller must not reuse
the caches or lanes it passed in.  Entry points run on ``cuda`` unless
``device="cpu"`` is asked for.  ``place_params`` puts the params on a
sharded pool's mesh: replicated, or, for a large policy over several
processes, sharded across them (``PlacedPolicy``) and gathered at each
use.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.device import resolve_device
from repro_torch.core.specs import EnvSpec, TimeStep
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.distributed.sharding import (
    cuts,
    gather_policy,
    place_policy,
)
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    rms_head_norm,
    rope_tables,
)
from repro_torch.models.transformer import (
    lm_apply,
    lm_head,
    lm_init,
    unstack_layers,
)
from repro_torch.models.xlstm import xlstm_block_kinds
from repro_torch.utils.tree import (
    tree_dataclass,
    tree_gather,
    tree_leaves_with_path,
    tree_map,
)


# --------------------------------------------------------------------- #
# config / state
# --------------------------------------------------------------------- #
def default_policy_config(vocab: int, max_len: int = 64) -> ModelConfig:
    """Tiny dense decoder used as the default LM policy backbone (f32
    compute)."""
    return ModelConfig(
        name="lm-policy", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=vocab, head_dim=16,
        rope_theta=10_000.0, tie_embeddings=True,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        remat="none",
    )


@tree_dataclass
class LMLaneState:
    """Per-lane policy state, lane-major: ``k``/``v`` (N, n_layers, Hkv,
    T, hd) static cache rows in the ``decode_attention`` layout,
    ``length`` (N,) int32 valid cache entries, ``history`` (N, T) int32
    tokens consumed this episode (the full-recompute baseline's
    input)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    history: torch.Tensor


def params_from_jax(params_np: dict[str, Any], cfg: ModelConfig,
                    device: torch.device | str | None = None
                    ) -> dict[str, Any]:
    """The port's parameters from the numpy leaves of a ``repro``
    parameter pytree (``jax.tree.map(np.asarray, params)``) of
    ``LMPolicy.init``, a stacked ``lm_init``, ``xlstm_lm_init`` or
    ``whisper_init``: the same nested dicts and lists, so both packages
    compute with the same weights.  Shapes are checked per family: a
    decoder's layer leaves stacked on their leading ``n_layers`` dim
    (the experts' ``moe.wi`` (L, E, d, ff) and a hybrid's ``ssm.A_log``,
    ``ssm.conv`` and the rest alike), ``value_head`` included; an
    xLSTM's ``layers`` a list of one dict a layer of its block kind;
    Whisper's ``enc_layers`` stacked on ``enc_layers`` and
    ``dec_layers`` on ``n_layers``."""
    device = resolve_device(device)

    def load(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: load(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [load(v) for v in x]
        return torch.tensor(np.asarray(x), dtype=cfg.param_dtype,
                            device=device)

    def want(name: str, got: torch.Tensor, shape: tuple[int, ...]) -> None:
        if tuple(got.shape) != shape:
            raise ValueError(f"{name} {tuple(got.shape)}, want {shape}")

    def stacked(name: str, tree: Any, count: str) -> None:
        n = getattr(cfg, count)
        for path, leaf in tree_leaves_with_path(tree):
            if leaf.shape[0] != n:
                raise ValueError(f"{name}.{path}: leading dim "
                                 f"{leaf.shape[0]}, want {count}={n}")

    params = load(params_np)
    V, d = cfg.vocab, cfg.d_model
    if cfg.family == "encdec":
        want("dec_embed", params["dec_embed"], (V, d))
        want("dec_pos", params["dec_pos"], (cfg.max_seq, d))
        want("lm_head", params["lm_head"], (d, V))
        stacked("enc_layers", params["enc_layers"], "enc_layers")
        stacked("dec_layers", params["dec_layers"], "n_layers")
        return params
    want("embed", params["embed"], (V, d))
    if cfg.family == "ssm":
        kinds = xlstm_block_kinds(cfg)
        got = [sorted(set(layer) - {"norm"}) for layer in params["layers"]]
        if got != [[kind] for kind in kinds]:
            raise ValueError(f"layers {got}, want {kinds}")
        return params
    stacked("layers", params["layers"], "n_layers")
    return params


class LMPolicy:
    """KV-cached transformer policy over an ``EnvSpec`` token stream.

    ``obs_slot`` picks which observation token the LM consumes each
    recv (default: the newest revealed prompt token of ``TokenEnv``'s
    context window, ``ctx_len // 2 - 1``)."""

    def __init__(self, spec: EnvSpec, cfg: ModelConfig | None = None,
                 max_len: int = 64, obs_slot: int | None = None,
                 device: torch.device | str | None = None):
        vocab = int(spec.act_spec.maximum) + 1
        self.cfg = cfg or default_policy_config(vocab, max_len)
        if self.cfg.moe is not None or self.cfg.ssm is not None:
            raise ValueError("LMPolicy supports dense transformer "
                             "backbones only")
        self.spec = spec
        self.max_len = int(max_len)
        if obs_slot is None:
            obs_slot = int(spec.obs_spec.shape[0]) // 2 - 1
        self.obs_slot = int(obs_slot)
        self.device = resolve_device(device)

    # ------------------------------ init --------------------------- #
    def init(self, gen: torch.Generator) -> dict[str, Any]:
        """``lm_init`` weights plus a value head on the final hidden
        state, drawn from ``gen`` (a generator on the policy's
        device)."""
        cfg = self.cfg
        params = lm_init(gen, cfg, self.device)
        params["value_head"] = {
            "w": dense_init(gen, cfg.d_model, 1, cfg.param_dtype,
                            self.device),
            "b": torch.zeros((1,), dtype=cfg.param_dtype,
                             device=self.device),
        }
        return params

    def place_params(self, params: dict[str, Any], pool: Any
                     ) -> dict[str, Any] | PlacedPolicy:
        """The Seed-RL placement over the pool's mesh
        (``distributed/sharding.py::place_policy``).  Below its
        ``min_shard_params``, or in solo, where every shard shares the
        process's device, the params come back replicated on the pool's
        device.  A policy the rule shards over a mesh of several
        processes is FSDP over them: a ``PlacedPolicy`` holding this
        process's slice of each leaf the plan shards (every rank cuts
        its slice from the full leaf it holds, so placing moves no
        data) and the rest whole, on the pool's device; ``decode_step``
        and ``full_forward`` gather it whole at each use
        (``gather_policy``, one ``"policy"`` gather on the mesh's log).
        Every process of the mesh calls it."""
        mesh = getattr(pool, "mesh", None)
        if mesh is None:
            return params
        local, plan = place_policy(mesh, params)
        local = tree_map(lambda x: x.to(pool.device), local)
        return PlacedPolicy(local, plan, mesh) if cuts(mesh, plan) else local

    def init_lanes(self, num_envs: int) -> LMLaneState:
        cfg = self.cfg
        shape = (num_envs, cfg.n_layers, cfg.n_kv_heads, self.max_len,
                 cfg.hd)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return LMLaneState(
            k=zeros(shape, cfg.compute_dtype),
            v=zeros(shape, cfg.compute_dtype),
            length=zeros((num_envs,), torch.int32),
            history=zeros((num_envs, self.max_len), torch.int32),
        )

    def cast_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """The weights every forward casts to the compute dtype, cast
        once: the same numbers as casting at each use, without re-reading
        the f32 weights on every step.  Norm scales stay as they are
        (the norms read them in f32)."""
        cd = self.cfg.compute_dtype
        norms = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm")

        def cast(tree: dict[str, Any]) -> dict[str, Any]:
            return {k: v if k in norms else
                    cast(v) if isinstance(v, dict) else v.to(cd)
                    for k, v in tree.items()}

        if isinstance(params, PlacedPolicy):
            return params.replace(local=cast(params.local))
        return cast(params)

    # ------------------------- cached decode ----------------------- #
    def decode_step(self, params: dict[str, Any], tokens: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor
                    ) -> tuple[torch.Tensor, ...]:
        """One KV-cached token per lane: ``tokens`` (B,) int32 at
        positions ``lengths`` (B,) int32 against caches (B, n_layers,
        Hkv, T, hd).  Returns ``(logits (B, V), value (B,), k_cache,
        v_cache)``, the caches written in place at each lane's position
        (clamped to the last slot, as ``dynamic_update_slice`` clamps)."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        params = gathered(params)
        B = tokens.shape[0]
        pos = lengths.to(torch.int32)
        rows = torch.arange(B, device=tokens.device)
        slot = torch.clamp(pos, 0, k_cache.shape[3] - 1).long()
        attend = pos + 1  # causal step t sees keys 0..t
        rope = rope_tables(pos[:, None], cfg)
        x = params["embed"][tokens.long()].to(cd)          # (B, d)

        for i, lp in enumerate(unstack_layers(params["layers"],
                                              cfg.n_layers)):
            ap = lp["attn"]
            normed = apply_norm(lp["attn_norm"], x, cfg)
            q = (normed @ ap["wq"].to(cd)).reshape(
                B, 1, cfg.n_heads, cfg.hd)
            kt = (normed @ ap["wk"].to(cd)).reshape(
                B, 1, cfg.n_kv_heads, cfg.hd)
            vt = (normed @ ap["wv"].to(cd)).reshape(
                B, 1, cfg.n_kv_heads, cfg.hd)
            if cfg.qk_norm:
                q = rms_head_norm(ap["q_norm"], q)
                kt = rms_head_norm(ap["k_norm"], kt)
            q = apply_rope(q, rope, cfg)[:, 0]              # (B, H, hd)
            kt = apply_rope(kt, rope, cfg)[:, 0]            # (B, Hkv, hd)
            kc, vc = k_cache[:, i], v_cache[:, i]           # strided views
            kc[rows, :, slot] = kt
            vc[rows, :, slot] = vt[:, 0]
            attn = decode_attention(q, kc, vc, attend)
            x = x + attn.reshape(B, cfg.q_dim) @ ap["wo"].to(cd)
            normed = apply_norm(lp["mlp_norm"], x, cfg)
            x = x + apply_mlp(lp["mlp"], normed, cfg)

        x = apply_norm(params["final_norm"], x, cfg)
        logits = lm_head(params, x, cfg)
        vh = params["value_head"]
        value = (x @ vh["w"].to(cd) + vh["b"].to(cd))[:, 0]
        return logits, value, k_cache, v_cache

    # ---------------------- full-recompute baseline ----------------- #
    def full_forward(self, params: dict[str, Any], history: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        """No-cache forward over the whole (padded) history, (B, T) int32
        with ``lengths`` (B,) valid tokens: the logits of each lane's
        last valid position."""
        logits_all = lm_apply(gathered(params), history, self.cfg)[0]
        idx = torch.clamp(lengths.long() - 1, 0, history.shape[1] - 1)
        return logits_all[torch.arange(history.shape[0],
                                       device=idx.device), idx]

    # --------------------------- act ------------------------------- #
    def extract_token(self, obs: torch.Tensor) -> torch.Tensor:
        """The observation token the LM consumes this recv."""
        return obs[..., self.obs_slot].to(torch.int32)

    def _consume(self, lanes_blk: LMLaneState, ts: TimeStep
                 ) -> tuple[torch.Tensor, torch.Tensor, LMLaneState]:
        """Episode boundaries and the history append for a served block:
        ``ts.done`` marks lanes whose obs opens a fresh episode, so their
        cache restarts at position 0."""
        pos = torch.where(ts.done, 0, lanes_blk.length)
        pos = torch.clamp(pos, max=self.max_len - 1).to(torch.int32)
        tok = self.extract_token(ts.obs)
        rows = torch.arange(tok.shape[0], device=tok.device)
        hist = lanes_blk.history.index_put((rows, pos.long()), tok)
        return tok, pos, lanes_blk.replace(history=hist)

    def act(self, params: dict[str, Any], lanes: LMLaneState, ts: TimeStep,
            key: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, LMLaneState]:
        """One cached decode over the served block: gather the block's
        lane rows by ``ts.env_id``, decode one token, write them back
        into ``lanes``.  Returns ``(actions, logp, value, lanes)``;
        greedy when ``key`` is None."""
        ids = ts.env_id.long()
        blk = tree_gather(lanes, ids)
        tok, pos, blk = self._consume(blk, ts)
        logits, value, kc, vc = self.decode_step(params, tok, blk.k, blk.v,
                                                 pos)
        blk = blk.replace(k=kc, v=vc, length=pos + 1)
        actions, logp = _select(logits, key)
        return actions, logp, value, _scatter_(lanes, ids, blk)

    def act_full(self, params: dict[str, Any], lanes: LMLaneState,
                 ts: TimeStep, key: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, LMLaneState]:
        """The cache-less twin of ``act``: the same lane-state carriage,
        but every step re-runs the full forward over the history."""
        ids = ts.env_id.long()
        blk = tree_gather(lanes, ids)
        _, pos, blk = self._consume(blk, ts)
        logits = self.full_forward(params, blk.history, pos + 1)
        blk = blk.replace(length=pos + 1)
        actions, logp = _select(logits, key)
        return actions, logp, _scatter_(lanes, ids, blk)


@tree_dataclass
class PlacedPolicy:
    """A policy placed across an ``EnvMesh``'s processes by
    ``LMPolicy.place_params``: ``local`` is this process's part of the
    params (``place_policy``), ``plan`` ``policy_shardings``' dims."""

    local: Any
    plan: Any
    mesh: Any


def gathered(params: dict[str, Any] | PlacedPolicy) -> dict[str, Any]:
    """The whole params of a ``PlacedPolicy`` (``gather_policy``): the
    weights a forward reads, as GSPMD gathers an FSDP-sharded weight at
    its use; plain params as they are."""
    if isinstance(params, PlacedPolicy):
        return gather_policy(params.mesh, params.local, params.plan)
    return params


def _scatter_(lanes: LMLaneState, ids: torch.Tensor, blk: LMLaneState
              ) -> LMLaneState:
    """Write the block's rows back into ``lanes``' tensors, in place."""
    tree_map(lambda full, rows: full.index_copy_(0, ids, rows.to(full.dtype)),
             lanes, blk)
    return lanes


def _select(logits: torch.Tensor, key: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(actions (B,) int32, logp (B,) f32)``: argmax, or a
    Gumbel-max sample from ``key``."""
    logp_all = torch.log_softmax(logits.float(), dim=-1)
    if key is None:
        actions = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        actions = random.categorical(key, logits.float()).to(torch.int32)
    logp = logp_all.gather(1, actions.long()[:, None])[:, 0]
    return actions, logp


# --------------------------------------------------------------------- #
# collect loop
# --------------------------------------------------------------------- #
def build_lm_collect_fn(pool: Any, policy: LMPolicy, num_steps: int,
                        cached: bool = True, greedy: bool = False
                        ) -> Callable:
    """``collect(ps, lanes, params, last_ts, key) -> (ps, lanes, last_ts,
    traj, actions)``: ``num_steps`` recvs with the LM policy acting on
    each served block, as an eager loop (the JAX package's donated
    ``lax.scan``).  Step ``t`` samples with ``random.split(key,
    num_steps)[t]``; ``traj`` stacks the TimeStep each step acted on,
    ``actions`` the actions.  ``cached=False`` swaps in the
    full-recompute forward.  ``lanes`` is updated in place."""

    def collect(ps, lanes, params, last_ts, key):
        params = policy.cast_params(params)
        keys = random.split(key, num_steps)
        ts, traj, acts = last_ts, [], []
        for t in range(num_steps):
            k = None if greedy else keys[t]
            if cached:
                actions, _, _, lanes = policy.act(params, lanes, ts, k)
            else:
                actions, _, lanes = policy.act_full(params, lanes, ts, k)
            traj.append(ts)
            acts.append(actions)
            ps, ts = pool.step(ps, actions, ts.env_id)
        traj = tree_map(lambda *xs: torch.stack(xs), traj[0], *traj[1:])
        return ps, lanes, ts, traj, torch.stack(acts)

    return collect


__all__ = [
    "LMLaneState",
    "LMPolicy",
    "PlacedPolicy",
    "build_lm_collect_fn",
    "default_policy_config",
    "params_from_jax",
]
