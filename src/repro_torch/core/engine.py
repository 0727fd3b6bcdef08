"""The device engine (``repro/core/engine.py`` + ``core/device_pool.py``):
EnvPool's send/recv over N env lanes on a 1-D mesh of D shards.

One class, ``MeshEnvPool``, serves every mesh size, as in the JAX
package: ``engine="device"`` and ``"device-masked"`` are its one-shard
mesh (``DeviceEnvPool`` is the same class), ``engine="device-sharded"``
the same body over D shards, solo on one device or dealt to the
processes of a ``torch.distributed`` job (``EnvMesh``).

Per-env init keys come from ``derive_env_keys``, the formula every
engine of the JAX package shares, so the same key gives the same
per-env streams as ``repro.make(..., engine="device")``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.device import resolve_device
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
    is_value,
    tree_dataclass,
    tree_gather,
    tree_leaves_with_path,
    tree_map,
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
    """The pool's whole execution state.  Per-lane fields lead with the
    N lanes the process holds; ``tick`` (D_local,) int32, ``rng``
    (D_local, 2) and the per-shard counters lead with the process's
    shards, as in the JAX package."""

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
    tick: torch.Tensor         # (D_local,) int32 recv counter
    rng: torch.Tensor          # (D_local, 2) keys
    tf_state: Any = ()         # one entry per transform
    telemetry: Any = ()        # Telemetry when the pool has obs=True


# ---------------------------------------------------------------------- #
# the mesh of D env shards, on one device or over processes, and the
# engine over it
# ---------------------------------------------------------------------- #
def _dist() -> Any:
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class EnvMesh:
    """A 1-D mesh of ``num_shards`` env shards, the port's counterpart of
    the JAX package's 1-D device mesh.

    *solo*: one process holds every shard, on its ``device``.  *ranks*:
    the shards are dealt in order to the processes ``ranks`` of a
    ``torch.distributed`` job, D/P contiguous shards each on the
    process's own device; ``group`` is their process group (None: the
    whole job).  A process outside ``ranks`` holds no shard
    (``local_shards == 0``), as the learner of ``train_disaggregated``.

    The mesh issues the engine's collectives and counts them:
    ``log`` holds ``(kind, bytes gathered)`` for each, whether or not it
    crossed processes (in solo a gather is the local block itself).
    Over gloo a CUDA tensor is staged through the host."""

    def __init__(self, num_shards: int, device: torch.device | str,
                 ranks: tuple[int, ...] = (0,), group: Any = None):
        self.num_shards = int(num_shards)
        self.device = torch.device(device)
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        p = len(self.ranks)
        if list(self.ranks) != sorted(set(self.ranks)):
            raise ValueError(f"ranks must be distinct and sorted: {ranks}")
        if self.num_shards < 1 or self.num_shards % p:
            raise ValueError(f"num_shards={self.num_shards} must be a "
                             f"positive multiple of the {p} processes")
        dist = _dist()
        me = dist.get_rank() if dist is not None else 0
        if p > 1 and dist is None:
            raise RuntimeError("a mesh over several processes needs "
                               "torch.distributed (launch/mesh.py::"
                               "initialize_multihost)")
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.local_shards = 0 if self.index is None else self.num_shards // p
        self.first_shard = (self.index or 0) * (self.num_shards // p)
        self.log: list[tuple[str, int]] = []

    @property
    def is_multiprocess(self) -> bool:
        return len(self.ranks) > 1

    def counts(self) -> dict[str, int]:
        """Collectives issued since the last ``reset_log``, by kind."""
        out: dict[str, int] = {}
        for kind, _ in self.log:
            out[kind] = out.get(kind, 0) + 1
        return out

    def reset_log(self) -> None:
        self.log.clear()

    def gather(self, x: torch.Tensor, kind: str, dim: int = 0
               ) -> torch.Tensor:
        """Concatenate every process's ``x`` along ``dim``, in shard
        order: ``(D/P, ...) -> (D, ...)`` for per-shard values."""
        self.log.append((kind, x.numel() * x.element_size()
                         * len(self.ranks)))
        if not self.is_multiprocess:
            return x
        dist = _dist()
        staged = x.is_cuda and dist.get_backend(self.group) == "gloo"
        src = (x.cpu() if staged else x).contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if staged else out

    def replicate(self, tree: Any, kind: str = "replicate",
                  dim: int = 0) -> Any:
        """Every leaf gathered along ``dim`` (0: the lane or shard dim of
        a pool's leaves): the whole mesh's values on every process."""
        return tree_map(lambda x: x if x.ndim == 0
                        else self.gather(x, kind, dim), tree)


def make_env_mesh(num_shards: EnvMesh | int | None = None,
                  device: torch.device | str | None = None,
                  ranks: tuple[int, ...] | None = None) -> EnvMesh:
    """The mesh of a sharded pool.  Without ``torch.distributed`` (or with
    ``ranks`` of one process) it is solo: ``num_shards`` (default 1)
    shards on ``device``.  In a job it spans ``ranks`` (default every
    process), ``num_shards`` defaulting to one a process, each process's
    shards on its ``device`` (default its current card; the CPU only when
    asked for).  An ``EnvMesh`` passes through, if it is on ``device``.
    Every process of the job must call it, with the same ranks: a
    subgroup is made collectively."""
    if isinstance(num_shards, EnvMesh):
        if device is not None and torch.device(device) != num_shards.device:
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"{num_shards.device}")
        return num_shards
    dist = _dist()
    if ranks is None:
        ranks = tuple(range(dist.get_world_size())) if dist else (0,)
    ranks = tuple(ranks)
    if device is None and torch.cuda.is_available():
        device = f"cuda:{torch.cuda.current_device()}"
    dev = resolve_device(device)
    d = len(ranks) if num_shards is None else int(num_shards)
    group = None
    if (len(ranks) > 1 and dist is not None
            and dist.get_world_size() != len(ranks)):
        group = dist.new_group(list(ranks))
    return EnvMesh(d, dev, ranks, group)


class MeshEnvPool:
    """EnvPool over a 1-D mesh of D shards (the JAX package's
    ``MeshEnvPool``; paper §4.1's scale-out).  N and M are global; each
    shard owns N/D consecutive lanes and serves M/D of them a recv by its
    own selection, with no gather of env data.  ``engine="device"`` is
    this class at D = 1 (``DeviceEnvPool``), as in the JAX package.

    ``batch_size == num_envs`` is sync mode (every recv steps all N, the
    block in priority order); smaller is async (top-M under the pool's
    ``schedule``).  ``mode="masked"`` is the event-driven tick ablation:
    every busy lane advances one substep a tick until M results are READY.
    All methods are functions of ``PoolState``: they return a new state and
    never write into the one they were given.

    Layout: per-lane leaves are the ``(D_local * N/D, ...)`` lanes this
    process holds, viewed ``(D_local, N/D, ...)`` where a shard's own
    rows are picked, so the selected rows of all local shards go through
    one ``env_step`` launch (and, for Pong, one render, grayscale and
    resize launch) a recv.  ``tick``, ``rng``, the global transform state
    and the per-shard counters carry a leading ``(D_local,)`` dim, of 1
    on one shard, as the JAX package's state does.  ``recv`` returns the
    process's block in shard-major order with global ``env_id``s: in solo
    the whole M block, as the JAX package's engine does, so the drivers
    take it unchanged; across ranks the rank's own D_local M/D rows.
    ``send`` takes a block in the same order.  Sync blocks of a pool of
    D > 1 shards come in env-id order, which makes the stream the same at
    every D > 1; D = 1 keeps the priority order of the one-shard engine.
    The lane and row offsets are skipped where they are 0, so one shard
    launches no more kernels a recv than a flat layout would.

    On a recv at most two collectives run: the hierarchical schedule's
    ``(D, C)`` cost gather and ``NormalizeObs``' moment sums; both are
    counted on ``mesh.log``.  Host reads of remote rows go through
    ``replicate``.

    ``obs=True`` (the default, as in the JAX package) carries the engine's
    counters (``obs/telemetry.py``) on ``PoolState.telemetry``, updated on
    the card inside recv and read on the host only by ``stats(ps)``;
    ``obs=False`` leaves them out, and the recv is the uninstrumented
    one."""

    def __init__(self, env: Environment, num_envs: int,
                 batch_size: int | None = None, mode: str | None = None,
                 mesh: EnvMesh | int | None = None,
                 batched: bool | None = None, schedule: str = "fifo",
                 sched_patience: float = 1.0, transforms: Any = (),
                 obs: bool = True, device: torch.device | str | None = None):
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
        mesh = make_env_mesh(1 if mesh is None else mesh, device)
        d = mesh.num_shards
        if num_envs % d:
            raise ValueError(f"num_envs={num_envs} % num_shards={d}")
        if batch_size % d:
            raise ValueError(f"batch_size={batch_size} % num_shards={d}")
        self.env = env
        self.mesh = mesh
        self.device = mesh.device
        self.num_shards = d
        self._d_local = mesh.local_shards
        self.num_envs = int(num_envs)
        self.batch_size = int(batch_size)
        self.mode = mode
        self.obs = bool(obs)
        # masked mode: ticks run so far, counted on the host (the tick
        # loop's condition is read there anyway)
        self.masked_ticks = 0
        # lanes and results per shard
        n = self._n_local = self.num_envs // d
        self._m_local = self.batch_size // d
        self.scheduler = get_scheduler(schedule, mesh=mesh, num_shards=d,
                                       patience=sched_patience)
        self.pipeline = TransformPipeline(transforms, env.spec,
                                          mesh=mesh if d > 1 else None)
        # batched=False: the generic adapter (the A/B baseline), as in the
        # JAX package's engine
        self.benv = as_batch_env(env, native=batched)
        # callers see the transformed spec; act_spec never changes
        self.spec = self.pipeline.out_spec
        # the first lane and first block row of this process, and each
        # local shard's first row (None for one local shard: no add)
        self._lane0 = mesh.first_shard * n
        self._row0 = mesh.first_shard * self._m_local
        self._base = None if self._d_local == 1 else (torch.arange(
            self._d_local, dtype=torch.int32, device=self.device) * n)[:, None]

    @property
    def is_multiprocess(self) -> bool:
        return self.mesh.is_multiprocess

    @property
    def block_rows(self) -> tuple[int, int] | None:
        """``(first row, M)``: where this process's block sits in the
        global block of M rows; None when it holds the whole block."""
        return (self._row0, self.batch_size) if self.is_multiprocess else None

    # ------------------------------------------------------------------ #
    # the shard layout
    # ------------------------------------------------------------------ #
    def _shards(self, x: torch.Tensor) -> torch.Tensor:
        """A per-lane or per-block vector with its leading shard dim."""
        return x.reshape(self._d_local, -1)

    def _lane_tick(self, ps: PoolState) -> torch.Tensor:
        """The recv tick of each lane's shard (one tick broadcasts)."""
        if self._d_local == 1:
            return ps.tick
        return ps.tick.repeat_interleave(self._n_local)

    @staticmethod
    def _lanes(ps: PoolState, tick: torch.Tensor) -> SchedState:
        """The scheduler's signals of every lane held, one vector each."""
        return SchedState(phase=ps.phase, cost=ps.cost,
                          send_tick=ps.send_tick, tick=tick)

    def _sched_view(self, ps: PoolState) -> SchedState:
        """The signals a selection reads, ``(D_local, N/D)`` a field."""
        return SchedState(phase=self._shards(ps.phase),
                          cost=self._shards(ps.cost),
                          send_tick=self._shards(ps.send_tick),
                          tick=ps.tick[:, None])

    def _rows(self, idx: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(rows, ids, env_id)`` of a selection ``idx`` (D_local, M/D):
        the lane rows in the block's shard layout, the same as one int64
        vector, and the global env ids the block reports."""
        if self.mode == "sync" and self.num_shards > 1:
            # env-id order within a shard: the same shard-major stream
            # for every D > 1, whatever the per-shard cost order
            idx = torch.sort(idx, dim=-1).values
        rows = idx if self._base is None else idx + self._base
        flat = rows.reshape(-1)
        return rows, flat.long(), flat + self._lane0 if self._lane0 else flat

    def _send_ids(self, env_ids: Any) -> torch.Tensor:
        """The local lane rows of global ``env_ids``, int64."""
        ids = torch.as_tensor(env_ids, device=self.device).long()
        return ids - self._lane0 if self._lane0 else ids

    def _send_tick(self, ps: PoolState, ids: torch.Tensor) -> torch.Tensor:
        """The tick ``send`` stamps on lanes ``ids``: their shard's."""
        if self._d_local == 1:
            return ps.tick
        return ps.tick.index_select(
            0, torch.div(ids, self._n_local, rounding_mode="floor"))

    # ------------------------------------------------------------------ #
    # construction / reset
    # ------------------------------------------------------------------ #
    def init_from_keys(self, env_keys: torch.Tensor, rng: torch.Tensor
                       ) -> PoolState:
        """Every env resets from its row of the global ``env_keys``; all
        results READY (async_reset).  Shard d's rng is
        ``split(rng, D)[d]``, as in the JAX package."""
        if self._d_local == 0:
            raise RuntimeError("this process holds no shard of the pool's "
                               "mesh")
        d, lo, dev = self._d_local, self._lane0, self.device
        keys = env_keys.to(dev)[lo:lo + d * self._n_local]
        first = self.mesh.first_shard
        rngs = random.split(rng.to(dev), self.num_shards)
        n = keys.shape[0]
        act = self.spec.act_spec

        def zeros(dtype, shape=()):
            return torch.zeros((n,) + shape, dtype=dtype, device=dev)

        tele = ()
        if self.obs:
            tele = init_telemetry(n, dev)
            tele = tele.replace(**{f: self._per_shard(getattr(tele, f))
                                   for f in PER_SHARD_FIELDS})
        return PoolState(
            env_states=self.benv.v_init_state(keys),
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
            tick=torch.zeros((d,), dtype=torch.int32, device=dev),
            rng=rngs[first:first + d],
            tf_state=self._tf_shard(self.pipeline.init(n, dev)),
            telemetry=tele,
        )

    def _per_shard(self, x: torch.Tensor) -> torch.Tensor:
        return x.expand((self._d_local,) + tuple(x.shape)).clone()

    def _tf_shard(self, tf_state: Any) -> Any:
        """Global transform entries with a copy a local shard."""
        return tuple(s if t.per_lane else tree_map(self._per_shard, s)
                     for t, s in zip(self.pipeline.transforms, tf_state))

    def init(self, key: torch.Tensor) -> PoolState:
        env_keys, rng = derive_env_keys(key.to(self.device), self.num_envs)
        return self.init_from_keys(env_keys, rng)

    def reset(self, key: torch.Tensor) -> tuple[PoolState, TimeStep]:
        """init + the first block of M results."""
        return self.recv(self.init(key))

    # ------------------------------------------------------------------ #
    # send / recv
    # ------------------------------------------------------------------ #
    def send(self, ps: PoolState, actions: Any, env_ids: Any) -> PoolState:
        """Store ``actions`` for ``env_ids`` (the ids of a recv block)."""
        ids = self._send_ids(env_ids)
        actions = torch.as_tensor(actions, device=self.device).to(
            ps.actions.dtype)
        sel = tree_gather(ps.env_states, ids)
        costs = torch.clamp(self.benv.v_step_cost(sel, actions),
                            self.spec.min_cost, self.spec.max_cost)
        ss = self.scheduler.enqueue(
            self._lanes(ps, self._send_tick(ps, ids)), ids, costs)
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
        ss = self._sched_view(ps)
        if self.obs:
            idx, overdue = self.scheduler.select_info(ss, self._m_local)
        else:
            idx = self.scheduler.select(ss, self._m_local)
        rows, ids, env_id = self._rows(idx)
        if self.obs:
            # ticks waited, read before ``complete`` advances the tick; a
            # full block keeps it in lane order (record_serve's fast path)
            wait = ss.tick - (ss.send_tick if full_block else self._shards(
                ps.send_tick.index_select(0, ids)))
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
            env_id=env_id,
            episode_return=merge(ts.episode_return, ps.r_ep_return),
            episode_length=merge(ts.episode_length, ps.r_ep_length),
            step_cost=merge(ts.step_cost, ps.r_cost),
        )
        ss = self.scheduler.complete(self._lanes(ps, ps.tick), ids)
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
                ps.telemetry, rows, wait, self._shards(need_step),
                self._shards(out.step_cost), overdue,
                full_block=full_block))
        return self._serve(ps, ids, out)

    # ------------------------------------------------------------------ #
    # masked (event-driven tick) mode
    # ------------------------------------------------------------------ #
    def _tick(self, ps: PoolState, live: torch.Tensor | None = None
              ) -> PoolState:
        """Advance every HAS_ACTION lane one substep (of the ``live``
        lanes, when given); idle lanes are masked.  Pre-step, the substep
        and finalize (auto-reset draws included) run over all N lanes, as
        in the JAX package, so the streams stay the same."""
        busy = ps.phase == HAS_ACTION
        if live is not None:
            busy = busy & live
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
            send_tick=torch.where(finished, self._lane_tick(ps),
                                  ps.send_tick),
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
            new = new.replace(telemetry=record_finished(
                ps.telemetry, self._shards(finished), self._shards(ps.cost)))
        return new

    def _await_ready(self, ps: PoolState) -> PoolState:
        """Tick until each shard has its M/D results READY, only the
        shards still short ticking.  The JAX package runs the loop on the
        device (``lax.while_loop``); here it is a host loop whose
        condition is one device-to-host read a tick."""
        m = self._m_local
        while True:
            ready, busy = torch.stack([
                self._shards(ps.phase == READY).sum(-1),
                self._shards(ps.phase == HAS_ACTION).sum(-1)]).tolist()
            short = [r < m for r in ready]
            if not any(short):
                return ps
            for d, (r, b, s) in enumerate(zip(ready, busy, short)):
                if s and b == 0:
                    raise RuntimeError(
                        f"masked recv: shard {self.mesh.first_shard + d} "
                        f"has {r} results READY and no lane with an "
                        f"action, so {m} can never be served; send actions "
                        "for the ids of the last block first")
            live = None
            if not all(short):
                live = torch.tensor(short, device=self.device
                                    ).repeat_interleave(self._n_local)
            ps = self._tick(ps, live)
            self.masked_ticks += 1

    def _recv_masked(self, ps: PoolState) -> tuple[PoolState, TimeStep]:
        """Tick until M results are READY, then serve them in completion
        order."""
        ps = self._await_ready(ps)
        ss = self._sched_view(ps)
        rows, ids, env_id = self._rows(
            self.scheduler.select_ready(ss, self._m_local))
        out = TimeStep(
            obs=self.benv.v_observe(tree_gather(ps.env_states, ids)),
            reward=ps.r_reward.index_select(0, ids),
            done=ps.r_done.index_select(0, ids),
            terminated=ps.r_term.index_select(0, ids),
            truncated=ps.r_trunc.index_select(0, ids),
            env_id=env_id,
            episode_return=ps.r_ep_return.index_select(0, ids),
            episode_length=ps.r_ep_length.index_select(0, ids),
            step_cost=ps.r_cost.index_select(0, ids),
        )
        if self.obs:
            # waited since the step completed (``_tick`` stamps send_tick)
            wait = ss.tick - self._shards(ps.send_tick.index_select(0, ids))
            no = torch.zeros_like(rows)
            tele = record_serve(ps.telemetry, rows, wait, no.bool(), no,
                                no.new_zeros(()))
            ps = ps.replace(telemetry=tele)
        done = self.scheduler.complete(self._lanes(ps, ps.tick), ids)
        ps = ps.replace(phase=done.phase, tick=done.tick)
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

    def xla(self, seed: int = 0, key: torch.Tensor | None = None):
        """``(handle, recv, send, step)``, EnvPool's ``env.xla()``: the
        handle is the state initialised from ``key``, else from
        ``PRNGKey(seed)``; the others are the pool's own functions of it
        (eager; the JAX package returns them jitted)."""
        handle = self.init(random.PRNGKey(seed) if key is None else key)
        return handle, self.recv, self.send, self.step

    # ------------------------------------------------------------------ #
    # host reads and placement
    # ------------------------------------------------------------------ #
    def replicate(self, tree: Any) -> Any:
        """Every leaf gathered on its leading (lane, shard or row) dim, so
        every process holds the mesh's whole value: host reads only,
        never on a recv (it moves env data)."""
        return self.mesh.replicate(tree)

    def put_batch(self, tree: Any) -> Any:
        """This process's rows of a global ``(M, ...)`` shard-major
        batch, on the pool's device (every process passes the same)."""
        lo, hi = self._row0, self._row0 + self._d_local * self._m_local
        return tree_map(lambda x: torch.as_tensor(x)[lo:hi].to(self.device),
                        tree, is_leaf=is_value)

    def put_replicated(self, tree: Any) -> Any:
        """A value every shard reads whole (e.g. the init key), on the
        pool's device."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree,
                        is_leaf=is_value)

    def device_put(self, ps: PoolState) -> PoolState:
        """The state on the mesh: it already is (the JAX package's
        explicit layout)."""
        return ps

    def state_shardings(self, ps: PoolState) -> Any:
        """The layout as a plan: every leaf with a dim is partitioned on
        its leading (lane or shard) dim over the mesh, ``("env",
        None, ...)``; 0-dim leaves are replicated, ``()``."""
        return tree_map(lambda x: ("env",) + (None,) * (x.ndim - 1)
                        if x.ndim else (), ps)

    def stats(self, ps: PoolState) -> dict:
        """The counters' host snapshot: per-shard partial sums added as
        integers, so it is bitwise the same at every D and process
        count.  Across processes the counters are gathered first."""
        if not self.obs:
            raise RuntimeError(
                "telemetry disabled: pool was constructed with obs=False")
        tele, tick = ps.telemetry, ps.tick
        if self.is_multiprocess:
            tele, tick = self.replicate((tele, tick))
        return snapshot_device(tele, tick)

    # ------------------------------------------------------------------ #
    # transform-state checkpoints
    # ------------------------------------------------------------------ #
    def _tf_canonical(self, tf_state: Any) -> Any:
        """Per-lane entries with all N rows, global entries without the
        shard dim (the copies are equal): the JAX package's form, the
        same at every mesh size."""
        return tuple(
            (self.mesh.replicate(s) if t.per_lane
             else tree_map(lambda x: x[0], s))
            for t, s in zip(self.pipeline.transforms, tf_state))

    def save_transform_state(self, store, step, ps, meta=None):
        """Save the canonical transform state; across processes the mesh's
        first process writes it (the others return None)."""
        canon = self._tf_canonical(ps.tf_state)
        if self.mesh.index != 0:
            return None
        return store.save(step, canon, meta or {})

    def restore_transform_state(self, store, step, ps):
        """``ps`` with the transform state saved at ``step`` at any mesh
        size: global entries are copied to every local shard."""
        canon = store.restore(step, self._tf_canonical(ps.tf_state))
        lo, hi = self._lane0, self._lane0 + self._d_local * self._n_local
        return ps.replace(tf_state=tuple(
            (tree_map(lambda x: x[lo:hi], c) if t.per_lane
             else tree_map(self._per_shard, c))
            for t, c in zip(self.pipeline.transforms, canon)))


# one engine class serves every mesh size; the classic name is the
# one-shard default, as in the JAX package's core/device_pool.py
DeviceEnvPool = MeshEnvPool


# ---------------------------------------------------------------------- #
# carrying a PoolState across packages
# ---------------------------------------------------------------------- #
def pool_state_from_numpy(pool: MeshEnvPool, arrays: dict[str, Any]
                          ) -> PoolState:
    """A ``PoolState`` on the pool's device from numpy arrays keyed by
    field path (``env_states.pos``, ``tf_state.0.buf``,
    ``telemetry.serves``, ...), e.g. the leaves of the JAX package's
    ``PoolState`` through ``np.asarray``: the same layout, shard dims
    included; uint32 keys become int64."""
    template = pool.init(random.PRNGKey(0))
    want = {p for p, _ in tree_leaves_with_path(template)}
    have = set(arrays)
    if have != want:
        raise KeyError(f"field paths differ: missing {sorted(want - have)}, "
                       f"unexpected {sorted(have - want)}")

    def load(path: str, like: torch.Tensor) -> torch.Tensor:
        arr = np.asarray(arrays[path])
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{tuple(like.shape)}")
        if like.dtype == torch.int64:
            arr = arr.astype(np.int64)
        return torch.tensor(arr, dtype=like.dtype, device=like.device)

    return tree_map_with_path(load, template)


def pool_state_to_numpy(pool: MeshEnvPool, ps: PoolState
                        ) -> dict[str, np.ndarray]:
    """The inverse of ``pool_state_from_numpy``: keys as uint32."""
    out = {}
    for path, leaf in tree_leaves_with_path(ps):
        arr = leaf.detach().cpu().numpy()
        if leaf.dtype == torch.int64:
            arr = arr.astype(np.uint32)
        out[path] = arr
    return out


def make_pool(env: Environment, num_envs: int, batch_size: int | None = None,
              mode: str | None = None, batched: bool | None = None,
              schedule: str = "fifo", transforms: Any = (), obs: bool = True,
              device: torch.device | str = "cuda") -> MeshEnvPool:
    """The JAX package's ``make_pool``: the device engine over ``env``,
    sync iff ``batch_size`` is None or ``num_envs``, on ``device``."""
    return MeshEnvPool(env, num_envs, batch_size, mode=mode,
                       batched=batched, schedule=schedule,
                       transforms=transforms, obs=obs, device=device)


__all__ = [
    "DeviceEnvPool", "EnvMesh", "MeshEnvPool", "PoolState",
    "derive_env_keys", "make_env_mesh", "make_pool",
    "pool_state_from_numpy", "pool_state_to_numpy",
]
