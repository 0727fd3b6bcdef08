"""The device engine (``repro/core/engine.py`` + ``core/device_pool.py``):
EnvPool's send/recv over N env lanes that live on one device.

``DeviceEnvPool`` is the degenerate one-device body of the JAX package's
``MeshEnvPool``: no mesh and no shard dim, the same per-recv program.
``batch_size == num_envs`` is sync mode (every recv steps all N, the
block in priority order); smaller is async (top-M under the pool's
``schedule``).  ``mode="masked"`` is the event-driven tick ablation:
every busy lane advances one substep a tick until M results are READY.
All methods are functions of ``PoolState``: they return a new state and
never write into the one they were given.

``obs=True`` (the default, as in the JAX package) carries the engine's
counters (``obs/telemetry.py``) on ``PoolState.telemetry``, updated on
the card inside recv and read on the host only by ``stats(ps)``;
``obs=False`` leaves them out, and the recv is the uninstrumented one.

Per-env init keys come from ``derive_env_keys``, the formula every
engine of the JAX package shares, so the same key gives the same
per-env streams as ``repro.make(..., engine="device")``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.scheduler import (
    HAS_ACTION,
    READY,
    SchedState,
    get_scheduler,
)
from repro_torch.core.specs import TimeStep
from repro_torch.core.transforms import TransformPipeline
from repro_torch.envs.base import Environment
from repro_torch.envs.batch import as_batch_env
from repro_torch.obs.telemetry import (
    PER_SHARD_FIELDS,
    init_telemetry,
    record_finished,
    record_serve,
    snapshot_device,
)
from repro_torch.utils.tree import (
    tree_dataclass,
    tree_gather,
    tree_leaves_with_path,
    tree_map_with_path,
    tree_scatter,
    tree_where,
)


def derive_env_keys(key: torch.Tensor, num_envs: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(env_keys (N, 2), pool_rng (2,))`` from one key."""
    rng, sub = random.split(key)
    return random.split(sub, num_envs), rng


@tree_dataclass
class PoolState:
    """The pool's whole execution state.  Per-lane fields lead with N;
    ``tick`` is a 0-dim int32 and ``rng`` one key (the JAX package
    carries both with a leading shard dim of 1)."""

    env_states: Any
    phase: torch.Tensor        # (N,) int32
    actions: torch.Tensor      # (N, *act_shape) action table
    cost: torch.Tensor         # (N,) int32 predicted cost of pending step
    send_tick: torch.Tensor    # (N,) int32 tick the action was enqueued
    progress: torch.Tensor     # (N,) int32 substeps done (masked mode)
    # stored results of READY lanes (obs is re-derived from env state)
    r_reward: torch.Tensor
    r_done: torch.Tensor
    r_term: torch.Tensor
    r_trunc: torch.Tensor
    r_ep_return: torch.Tensor
    r_ep_length: torch.Tensor
    r_cost: torch.Tensor
    tick: torch.Tensor         # () int32 recv counter
    rng: torch.Tensor          # (2,) key
    tf_state: Any = ()         # one entry per transform
    telemetry: Any = ()        # Telemetry when the pool has obs=True


class DeviceEnvPool:
    """EnvPool over ``num_envs`` lanes serving ``batch_size`` results per
    recv, on ``device``."""

    def __init__(self, env: Environment, num_envs: int,
                 batch_size: int | None = None, mode: str | None = None,
                 batched: bool | None = None, schedule: str = "fifo",
                 transforms: Any = (), obs: bool = True,
                 device: torch.device | str = "cuda"):
        if batch_size is None:
            batch_size = num_envs
        if mode is None:
            mode = "sync" if batch_size == num_envs else "async"
        if mode not in ("sync", "async", "masked"):
            raise ValueError(f"unknown mode {mode!r}")
        if batch_size > num_envs:
            raise ValueError("batch_size cannot exceed num_envs")
        if mode == "sync" and batch_size != num_envs:
            raise ValueError("sync mode requires batch_size == num_envs")
        self.env = env
        self.device = torch.device(device)
        self.num_envs = int(num_envs)
        self.batch_size = int(batch_size)
        self.mode = mode
        self.obs = bool(obs)
        # masked mode: ticks run so far, counted on the host (the tick
        # loop's condition is read there anyway)
        self.masked_ticks = 0
        self.scheduler = get_scheduler(schedule)
        self.pipeline = TransformPipeline(transforms, env.spec)
        # batched=False: the generic adapter (the A/B baseline), as in the
        # JAX package's engine
        self.benv = as_batch_env(env, native=batched)
        # callers see the transformed spec; act_spec never changes
        self.spec = self.pipeline.out_spec

    # ------------------------------------------------------------------ #
    # construction / reset
    # ------------------------------------------------------------------ #
    def init_from_keys(self, env_keys: torch.Tensor, rng: torch.Tensor
                       ) -> PoolState:
        """Every env resets; all results READY (async_reset)."""
        env_keys = env_keys.to(self.device)
        n = env_keys.shape[0]
        act = self.spec.act_spec
        dev = self.device

        def zeros(dtype, shape=()):
            return torch.zeros((n,) + shape, dtype=dtype, device=dev)

        return PoolState(
            env_states=self.benv.v_init_state(env_keys),
            phase=torch.full((n,), READY, dtype=torch.int32, device=dev),
            actions=zeros(act.dtype, act.shape),
            cost=zeros(torch.int32),
            send_tick=zeros(torch.int32),
            progress=zeros(torch.int32),
            r_reward=zeros(torch.float32),
            r_done=zeros(torch.bool),
            r_term=zeros(torch.bool),
            r_trunc=zeros(torch.bool),
            r_ep_return=zeros(torch.float32),
            r_ep_length=zeros(torch.int32),
            r_cost=zeros(torch.int32),
            tick=torch.zeros((), dtype=torch.int32, device=dev),
            # the JAX package gives each of its D shards split(rng, D)[d]
            rng=random.split(rng.to(dev), 1)[0],
            tf_state=self.pipeline.init(n, dev),
            telemetry=init_telemetry(n, dev) if self.obs else (),
        )

    def init(self, key: torch.Tensor) -> PoolState:
        env_keys, rng = derive_env_keys(key.to(self.device), self.num_envs)
        return self.init_from_keys(env_keys, rng)

    def reset(self, key: torch.Tensor) -> tuple[PoolState, TimeStep]:
        """init + the first block of M results."""
        return self.recv(self.init(key))

    # ------------------------------------------------------------------ #
    # send / recv
    # ------------------------------------------------------------------ #
    @staticmethod
    def _sched_view(ps: PoolState) -> SchedState:
        return SchedState(phase=ps.phase, cost=ps.cost,
                          send_tick=ps.send_tick, tick=ps.tick)

    def send(self, ps: PoolState, actions: Any, env_ids: Any) -> PoolState:
        """Store ``actions`` for ``env_ids`` (the ids of a recv block)."""
        ids = torch.as_tensor(env_ids, device=self.device).long()
        actions = torch.as_tensor(actions, device=self.device).to(
            ps.actions.dtype)
        sel = tree_gather(ps.env_states, ids)
        costs = torch.clamp(self.benv.v_step_cost(sel, actions),
                            self.spec.min_cost, self.spec.max_cost)
        ss = self.scheduler.enqueue(self._sched_view(ps), ids, costs)
        return ps.replace(
            actions=ps.actions.index_copy(0, ids, actions),
            phase=ss.phase, cost=ss.cost, send_tick=ss.send_tick,
            progress=ps.progress.index_fill(0, ids, 0),
        )

    def _serve(self, ps: PoolState, ids: torch.Tensor, out: TimeStep
               ) -> tuple[PoolState, TimeStep]:
        """The transform pipeline over one served raw block, lanes ``ids``
        (stored r_* results stay raw, so both recv flavours serve the
        same stream)."""
        if not self.pipeline:
            return ps, out
        blk, out = self.pipeline.apply(
            self.pipeline.gather(ps.tf_state, ids), out)
        return ps.replace(tf_state=self.pipeline.scatter(
            ps.tf_state, ids, blk)), out

    def _recv_topm(self, ps: PoolState) -> tuple[PoolState, TimeStep]:
        full_block = self.batch_size == self.num_envs
        if self.obs:
            idx, overdue = self.scheduler.select_info(self._sched_view(ps),
                                                      self.batch_size)
        else:
            idx = self.scheduler.select(self._sched_view(ps),
                                        self.batch_size)
        ids = idx.long()
        if self.obs:
            # ticks waited, read before ``complete`` advances the tick; a
            # full block keeps it in lane order (record_serve's fast path)
            wait = ps.tick - (ps.send_tick if full_block
                              else ps.send_tick.index_select(0, ids))
        sel_states = tree_gather(ps.env_states, ids)
        need_step = ps.phase.index_select(0, ids) == HAS_ACTION

        new_states, ts = self.benv.v_step(
            sel_states, ps.actions.index_select(0, ids), need_step)
        # ONE observe over the post-step states serves every lane: a
        # stepped lane's new state is its finalized state, and a lane
        # that only held a READY result kept its state, so this
        # re-derives its current obs
        obs = self.benv.v_observe(new_states)

        def merge(fresh, stored):
            return torch.where(need_step, fresh, stored.index_select(0, ids))

        out = TimeStep(
            obs=obs,
            reward=merge(ts.reward, ps.r_reward),
            done=merge(ts.done, ps.r_done),
            terminated=merge(ts.terminated, ps.r_term),
            truncated=merge(ts.truncated, ps.r_trunc),
            env_id=idx,
            episode_return=merge(ts.episode_return, ps.r_ep_return),
            episode_length=merge(ts.episode_length, ps.r_ep_length),
            step_cost=merge(ts.step_cost, ps.r_cost),
        )
        ss = self.scheduler.complete(self._sched_view(ps), idx)
        ps = ps.replace(
            env_states=tree_scatter(ps.env_states, ids, new_states),
            phase=ss.phase,
            r_reward=ps.r_reward.index_copy(0, ids, out.reward),
            r_done=ps.r_done.index_copy(0, ids, out.done),
            r_term=ps.r_term.index_copy(0, ids, out.terminated),
            r_trunc=ps.r_trunc.index_copy(0, ids, out.truncated),
            r_ep_return=ps.r_ep_return.index_copy(0, ids,
                                                  out.episode_return),
            r_ep_length=ps.r_ep_length.index_copy(0, ids,
                                                  out.episode_length),
            r_cost=ps.r_cost.index_copy(0, ids, out.step_cost),
            tick=ss.tick,
        )
        if self.obs:
            ps = ps.replace(telemetry=record_serve(
                ps.telemetry, idx, wait, need_step, out.step_cost, overdue,
                full_block=full_block))
        return self._serve(ps, ids, out)

    # ------------------------------------------------------------------ #
    # masked (event-driven tick) mode
    # ------------------------------------------------------------------ #
    def _tick(self, ps: PoolState) -> PoolState:
        """Advance every HAS_ACTION lane one substep; idle lanes are
        masked.  Pre-step, the substep and finalize (auto-reset draws
        included) run over all N lanes, as in the JAX package, so the
        streams stay the same."""
        busy = ps.phase == HAS_ACTION
        starting = busy & (ps.progress == 0)
        # clear the step's accumulators as it starts
        states = tree_where(starting, self.benv.v_pre_step(ps.env_states),
                            ps.env_states)
        stepped = self.benv.v_substep(states, ps.actions)
        running = busy & (ps.progress < ps.cost)
        states = tree_where(running, stepped, states)
        progress = torch.where(running, ps.progress + 1, ps.progress)
        finished = busy & (progress >= ps.cost)

        fin_states, fin_ts = self.benv.v_finalize(states, ps.cost)
        new = ps.replace(
            env_states=tree_where(finished, fin_states, states),
            progress=progress,
            phase=torch.where(finished, READY, ps.phase),
            send_tick=torch.where(finished, ps.tick, ps.send_tick),
            r_reward=torch.where(finished, fin_ts.reward, ps.r_reward),
            r_done=torch.where(finished, fin_ts.done, ps.r_done),
            r_term=torch.where(finished, fin_ts.terminated, ps.r_term),
            r_trunc=torch.where(finished, fin_ts.truncated, ps.r_trunc),
            r_ep_return=torch.where(finished, fin_ts.episode_return,
                                    ps.r_ep_return),
            r_ep_length=torch.where(finished, fin_ts.episode_length,
                                    ps.r_ep_length),
            r_cost=torch.where(finished, ps.cost, ps.r_cost),
        )
        if self.obs:
            # the substeps belong to the tick that finished the work; the
            # serve is recorded at recv with no stepped lanes
            new = new.replace(telemetry=record_finished(ps.telemetry,
                                                        finished, ps.cost))
        return new

    def _recv_masked(self, ps: PoolState) -> tuple[PoolState, TimeStep]:
        """Tick until M results are READY, then serve them in completion
        order.  The JAX package runs the loop on the device
        (``lax.while_loop``); here it is a host loop whose condition is
        one device-to-host read a tick."""
        m = self.batch_size
        while True:
            ready, busy = torch.stack([(ps.phase == READY).sum(),
                                       (ps.phase == HAS_ACTION).sum()
                                       ]).tolist()
            if ready >= m:
                break
            if busy == 0:
                raise RuntimeError(
                    f"masked recv: {ready} results READY and no lane has an "
                    f"action, so {m} can never be served; send actions "
                    "for the ids of the last block first")
            ps = self._tick(ps)
            self.masked_ticks += 1
        idx = self.scheduler.select_ready(self._sched_view(ps), m)
        ids = idx.long()
        out = TimeStep(
            obs=self.benv.v_observe(tree_gather(ps.env_states, ids)),
            reward=ps.r_reward.index_select(0, ids),
            done=ps.r_done.index_select(0, ids),
            terminated=ps.r_term.index_select(0, ids),
            truncated=ps.r_trunc.index_select(0, ids),
            env_id=idx,
            episode_return=ps.r_ep_return.index_select(0, ids),
            episode_length=ps.r_ep_length.index_select(0, ids),
            step_cost=ps.r_cost.index_select(0, ids),
        )
        ss = self.scheduler.complete(self._sched_view(ps), idx)
        if self.obs:
            # waited since the step completed (``_tick`` stamps send_tick)
            wait = ps.tick - ps.send_tick.index_select(0, ids)
            no = torch.zeros_like(idx)
            tele = record_serve(ps.telemetry, idx, wait, no.bool(), no,
                                no.new_zeros(()))
            ps = ps.replace(telemetry=tele)
        ps = ps.replace(phase=ss.phase, tick=ss.tick)
        return self._serve(ps, ids, out)

    def recv(self, ps: PoolState) -> tuple[PoolState, TimeStep]:
        """The next block of M results."""
        if self.mode == "masked":
            return self._recv_masked(ps)
        return self._recv_topm(ps)

    def step(self, ps: PoolState, actions: Any, env_ids: Any
             ) -> tuple[PoolState, TimeStep]:
        """``step = send ∘ recv``."""
        return self.recv(self.send(ps, actions, env_ids))

    def stats(self, ps: PoolState) -> dict:
        """The host snapshot of the engine's counters (``obs/telemetry.
        py::format_stats``): the only point where they leave the card."""
        if not self.obs:
            raise RuntimeError(
                "telemetry disabled: pool was constructed with obs=False")
        return snapshot_device(ps.telemetry, ps.tick)

    def xla(self, seed: int = 0, key: torch.Tensor | None = None):
        """``(handle, recv, send, step)``, EnvPool's ``env.xla()``: the
        handle is the state initialised from ``key``, else from
        ``PRNGKey(seed)``; the others are the pool's own functions of it
        (eager; the JAX package returns them jitted)."""
        handle = self.init(random.PRNGKey(seed) if key is None else key)
        return handle, self.recv, self.send, self.step

    # ------------------------------------------------------------------ #
    # transform-state checkpoints
    # ------------------------------------------------------------------ #
    def save_transform_state(self, store, step: int, ps: PoolState,
                             meta: dict | None = None) -> str:
        """Save ``ps.tf_state`` (e.g. ``NormalizeObs``'s running moments)
        through ``checkpoint/store.py``, in the JAX package's canonical
        form: per-lane entries with their N rows, global entries without
        a shard dim (the port has none)."""
        return store.save(step, ps.tf_state, meta or {})

    def restore_transform_state(self, store, step: int, ps: PoolState
                                ) -> PoolState:
        """``ps`` with the transform state saved at ``step``, e.g. by the
        JAX package's pool at any mesh size."""
        return ps.replace(tf_state=store.restore(step, ps.tf_state))


# ---------------------------------------------------------------------- #
# carrying a PoolState across packages
# ---------------------------------------------------------------------- #
def _shard_dim_paths(pool: DeviceEnvPool) -> tuple[str, ...]:
    """Path prefixes of the leaves the JAX package carries with a leading
    shard dim of 1: the recv tick, the rng, the counters that are not per
    lane and the global (not per-lane) transform entries."""
    return ("tick", "rng",
            *(f"telemetry.{f}" for f in PER_SHARD_FIELDS),
            *(f"tf_state.{i}" for i, t in enumerate(pool.pipeline.transforms)
              if not t.per_lane))


def _has_shard_dim(path: str, prefixes: tuple[str, ...]) -> bool:
    return any(path == p or path.startswith(p + ".") for p in prefixes)


def pool_state_from_numpy(pool: DeviceEnvPool, arrays: dict[str, Any]
                          ) -> PoolState:
    """A ``PoolState`` on the pool's device from numpy arrays keyed by
    field path (``env_states.pos``, ``tf_state.0.buf``,
    ``telemetry.serves``, ...), e.g. the leaves of the JAX package's
    ``PoolState`` through ``np.asarray``.  The leaves of
    ``_shard_dim_paths`` may carry the JAX package's leading shard dim of
    1; uint32 keys become int64."""
    template = pool.init(random.PRNGKey(0))
    want = {p for p, _ in tree_leaves_with_path(template)}
    have = set(arrays)
    if have != want:
        raise KeyError(f"field paths differ: missing {sorted(want - have)}, "
                       f"unexpected {sorted(have - want)}")
    sharded = _shard_dim_paths(pool)

    def load(path: str, like: torch.Tensor) -> torch.Tensor:
        arr = np.asarray(arrays[path])
        if _has_shard_dim(path, sharded) and arr.ndim == like.ndim + 1:
            arr = arr[0]
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{tuple(like.shape)}")
        if like.dtype == torch.int64:
            arr = arr.astype(np.int64)
        return torch.tensor(arr, dtype=like.dtype, device=like.device)

    return tree_map_with_path(load, template)


def pool_state_to_numpy(pool: DeviceEnvPool, ps: PoolState
                        ) -> dict[str, np.ndarray]:
    """The inverse of ``pool_state_from_numpy``, in the JAX package's
    layout: keys as uint32, ``_shard_dim_paths`` with a shard dim of 1."""
    sharded = _shard_dim_paths(pool)
    out = {}
    for path, leaf in tree_leaves_with_path(ps):
        arr = leaf.detach().cpu().numpy()
        if leaf.dtype == torch.int64:
            arr = arr.astype(np.uint32)
        if _has_shard_dim(path, sharded):
            arr = arr[None]
        out[path] = arr
    return out


def make_pool(env: Environment, num_envs: int, batch_size: int | None = None,
              mode: str | None = None, batched: bool | None = None,
              schedule: str = "fifo", transforms: Any = (), obs: bool = True,
              device: torch.device | str = "cuda") -> DeviceEnvPool:
    """The JAX package's ``make_pool``: the device engine over ``env``,
    sync iff ``batch_size`` is None or ``num_envs``, on ``device``."""
    return DeviceEnvPool(env, num_envs, batch_size, mode=mode,
                         batched=batched, schedule=schedule,
                         transforms=transforms, obs=obs, device=device)


__all__ = [
    "DeviceEnvPool", "PoolState", "derive_env_keys", "make_pool",
    "pool_state_from_numpy", "pool_state_to_numpy",
]
