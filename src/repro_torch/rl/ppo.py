"""PPO (Schulman et al. 2017) over the device engine, the paper's §4.2
integration (``repro/rl/ppo.py``).

``train_device`` is the fully device-resident driver: each iteration
collects ``num_steps`` recvs with the policy sampling on the served
block (the ``PoolState`` never leaves the card), forms GAE advantages
and runs the PPO epochs over shuffled minibatches, all as eager
PyTorch on the pool's device.  The only host sync of an iteration is
the one that reads its scalar metrics at its end.  The key flow is the
JAX package's, split for split, so a seed gives both packages the same
initial weights, the same collect keys and the same minibatch
permutations (``random.permutation``, bitwise).

``train_host`` trains over a host engine (thread, forloop,
subprocess), the configuration the paper's Fig. 4 profiles: envs
stepped by the host pool, the policy and the same PPO update on
``device`` (the card by default, wherever the pool is), each stage
timed as a fenced ``obs/trace.py`` span (env_step, inference, train,
other).

``train_pipelined`` splits an iteration in two halves that share no
output: the V-trace update of rollout t (``make_vtrace_ppo_update``) and
the collect of rollout t+1 behind the params from before that update
(``core/xla_loop.py::build_pipelined_collect_fn``), so the consumed
rollout is one policy step stale and V-trace (``rl/vtrace.py``,
``PPOConfig.rho_clip``/``c_clip``) corrects it.  On the card the update
runs on a second CUDA stream, dispatched first, so its device work runs
while the host dispatches the host-bound collect.
``train_host_pipelined`` is the same split over a host engine: an actor
thread streams served batches into a ``core/buffers.py::
StateBufferQueue`` while the learner takes blocks and runs the same
update.  ``train`` dispatches on ``is_functional``: ``train_device``
for the device engine, ``train_host`` for the rest.

The device drivers take a sharded pool (``MeshEnvPool``) as they take
the one-device engine.  In solo its recv block is the whole M block, so
nothing changes.  Across processes each collects its own rows, the
policy drawing its noise for the global block (``ActorCritic.sample``'s
``rows``), and the update gathers the rollout once an iteration, so
every process runs the same update on the whole rollout.  The policy
is placed as the JAX package places it
(``distributed/sharding.py::policy_shardings``): below 2^20 parameters
every process holds it whole and keeps the same params; past that
(PongClassic-v5's CNN) ``train_device`` holds each sharded leaf's slice
(``place_policy``), its AdamW moments too, and gathers the whole policy
for the collect and for each minibatch (``gather_policy``).

``train_disaggregated`` is the actor/learner split across processes:
the env processes collect on their mesh, the learner process runs the
V-trace update, and the rollout and params cross by ``host_broadcast``
each iteration, one policy step stale, as in ``train_pipelined``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.buffers import StateBufferQueue
from repro_torch.core.host_pool import numpy_dtype
from repro_torch.core.protocol import is_functional
from repro_torch.core.device import resolve_device
from repro_torch.core.xla_loop import (
    alloc_steps,
    build_pipelined_collect_fn,
    check_device_pool,
    write_step,
)
from repro_torch.obs.metrics import MetricsRegistry, publish_history
from repro_torch.obs.trace import Tracer
from repro_torch.distributed.sharding import (
    gather_policy,
    place_policy,
    take_rows,
)
from repro_torch.optim import adamw, global_norm, linear_decay
from repro_torch.rl.gae import gae
from repro_torch.rl.nets import ActorCritic
from repro_torch.rl.vtrace import vtrace
from repro_torch.utils.tree import tree_dataclass, tree_leaves, tree_map


@dataclasses.dataclass
class PPOConfig:
    """The JAX package's ``PPOConfig``, field for field."""

    total_steps: int = 100_000
    num_steps: int = 128          # rollout length per env (N_steps)
    lr: float = 2.5e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 4
    minibatches: int = 4
    max_grad_norm: float = 0.5
    anneal_lr: bool = True
    vf_clip: bool = True
    # V-trace truncation thresholds (rho-bar / c-bar, Espeholt et al.
    # 2018) for the pipelined drivers' stale rollouts; train_device and
    # train_host keep plain GAE.
    rho_clip: float = 1.0
    c_clip: float = 1.0


@tree_dataclass
class PPOState:
    params: Any
    opt: Any
    step: torch.Tensor      # () int32 minibatch updates taken


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum, then a minimum.  At a bound each splits
    the gradient in half, as ``jnp.clip`` does; ``torch.clamp`` would
    pass all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def make_ppo_update(net: ActorCritic, cfg: PPOConfig, total_updates: int,
                    mesh: Any = None, plan: Any = None):
    """``(optimizer, update)``; ``update(state, rollout, key) -> (state,
    metrics)`` runs ``cfg.epochs`` epochs of ``cfg.minibatches``
    minibatches over the ``(T, M, ...)`` rollout leaves ``obs``,
    ``actions``, ``logp``, ``values``, ``adv`` and ``ret``.  Each epoch
    shuffles the ``B = T * M`` samples with ``random.permutation`` and
    takes minibatches of ``B // minibatches``, dropping the tail.  The
    metrics are 0-dim tensors on the device.

    Each minibatch gathers the whole params (``gather_policy``), takes
    the gradient of the whole leaves, clips by the whole gradient's
    global norm and runs AdamW on this process's rows (``take_rows``).
    Without an ``EnvMesh``, or with a ``plan`` that cuts nothing across
    its processes (``distributed/sharding.py::cuts``), the gather and
    the cut hand the tree back as it is.  Where it cuts the policy
    (``place_policy``), ``state.params`` and the AdamW moments are this
    process's slices; every process holds the whole rollout, so every
    process computes the same whole gradient."""
    opt = adamw(b1=0.9, b2=0.999, eps=1e-5, weight_decay=0.0,
                clip_norm=cfg.max_grad_norm)
    lr_fn = (linear_decay(cfg.lr, total_updates) if cfg.anneal_lr
             else (lambda s: cfg.lr))

    def loss_fn(params, batch):
        logp, ent, v = net.logp_entropy(params, batch["obs"], batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        # the population std (ddof 0), as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * _clip(ratio, 1 - cfg.clip, 1 + cfg.clip)
        pg_loss = torch.mean(torch.maximum(pg1, pg2))
        if cfg.vf_clip:
            v_clip = batch["values"] + _clip(v - batch["values"], -cfg.clip,
                                             cfg.clip)
            vf_loss = 0.5 * torch.mean(torch.maximum(
                (v - batch["ret"]) ** 2, (v_clip - batch["ret"]) ** 2))
        else:
            vf_loss = 0.5 * torch.mean((v - batch["ret"]) ** 2)
        ent_loss = -torch.mean(ent)
        loss = pg_loss + cfg.vf_coef * vf_loss + cfg.ent_coef * ent_loss
        return loss, {"pg": pg_loss, "vf": vf_loss, "ent": -ent_loss,
                      "ratio": torch.mean(ratio)}

    def grad_fn(params, batch):
        """``((loss, metrics), grads)``, the grads a tree like params."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        metrics = {k: m.detach() for k, m in metrics.items()}
        return (loss.detach(), metrics), tree_map(lambda _: next(grads),
                                                  leaves)

    def update(state: PPOState, rollout: dict[str, torch.Tensor],
               key: torch.Tensor):
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in rollout.items()}
        B = flat["obs"].shape[0]
        mb = B // cfg.minibatches
        losses, history = [], []
        for ek in random.split(key, cfg.epochs):
            perm = random.permutation(ek, B)
            for i in range(cfg.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v.index_select(0, idx) for k, v in flat.items()}
                whole = gather_policy(mesh, state.params, plan)
                (loss, metrics), grads = grad_fn(whole, batch)
                norm = global_norm(grads)
                grads = take_rows(mesh, grads, plan)
                params, opt_state = opt.update(grads, state.opt, state.params,
                                               lr_fn(state.step), norm)
                state = PPOState(params, opt_state, state.step + 1)
                losses.append(loss)
                history.append(metrics)
        out = {k: torch.mean(torch.stack([m[k] for m in history]))
               for k in history[0]}
        out["loss"] = torch.mean(torch.stack(losses))
        return state, out

    return opt, update


def make_vtrace_ppo_update(net: ActorCritic, cfg: PPOConfig,
                           total_updates: int):
    """The pipelined learner's update, V-trace-corrected PPO:
    ``(optimizer, update)``.

    ``update(state, traj, key)`` takes the pipelined collect's rollout
    (``obs``, ``actions``, the behavior ``logp``, ``rewards``, ``dones``,
    ``last_obs``), recomputes the target log-probs and values under the
    current params, forms V-trace's value targets and rho-clipped
    advantages, then runs ``make_ppo_update``'s epochs (the clipped
    ratio taken against the behavior log-prob).  The metrics add
    ``rho_behavior``, the mean importance ratio pi/mu over the rollout
    (1.0: no lag).  Shared by ``train_pipelined`` and
    ``train_host_pipelined``."""
    opt, ppo_update = make_ppo_update(net, cfg, total_updates)

    def update(state: PPOState, traj: dict[str, torch.Tensor],
               key: torch.Tensor):
        T, M = traj["rewards"].shape
        with torch.no_grad():
            obs = traj["obs"].reshape((T * M,) + tuple(traj["obs"].shape[2:]))
            act = traj["actions"].reshape(
                (T * M,) + tuple(traj["actions"].shape[2:]))
            target_logp, _, v = net.logp_entropy(state.params, obs, act)
            target_logp = target_logp.reshape(T, M)
            values = v.reshape(T, M)
            last_v = net.forward(state.params, traj["last_obs"])[1]
            vs, pg_adv = vtrace(traj["logp"], target_logp, traj["rewards"],
                                values, traj["dones"], last_v,
                                gamma=cfg.gamma, lam=cfg.lam,
                                rho_clip=cfg.rho_clip, c_clip=cfg.c_clip)
            rho = torch.mean(torch.exp(target_logp - traj["logp"]))
        rollout = {"obs": traj["obs"], "actions": traj["actions"],
                   "logp": traj["logp"], "values": values,
                   "adv": pg_adv, "ret": vs}
        state, metrics = ppo_update(state, rollout, key)
        return state, dict(metrics, rho_behavior=rho)

    return opt, update


def _episode_metrics(traj_dones: torch.Tensor, traj_ep_ret: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Episode stats on the device: (episodes, ep_sum) scalars; the
    division happens on the host, where a zero count is handled."""
    episodes = torch.sum(traj_dones)
    ep_sum = torch.sum(torch.where(traj_dones, traj_ep_ret, 0.0))
    return episodes, ep_sum


def _record(history: list[dict], rec: dict, episodes: int, ep_sum: float,
            log_fn: Callable[[dict], None] | None,
            registry: MetricsRegistry | None = None) -> None:
    """Append one iteration record, carrying ``mean_return`` forward when
    the iteration completed no episode (``ep_sum / 0`` would be NaN,
    which strict JSON refuses).  With a ``registry``, the record is also
    published as ``ppo_*`` metrics (``obs/metrics.py``)."""
    if episodes > 0:
        mean_return = ep_sum / episodes
    else:
        mean_return = history[-1]["mean_return"] if history else 0.0
    rec = dict(rec, episodes=episodes, mean_return=float(mean_return))
    history.append(rec)
    if registry is not None:
        publish_history(registry, rec)
    if log_fn:
        log_fn(rec)


# --------------------------------------------------------------------- #
# fully on-device driver
# --------------------------------------------------------------------- #
def train_device(pool: Any, cfg: PPOConfig, seed: int = 0,
                 log_fn: Callable[[dict], None] | None = None,
                 hidden: tuple[int, ...] = (256, 128, 64)):
    """PPO on a ``repro_torch.make`` pool, on the pool's device (the card
    unless it was made with ``device="cpu"``).  Returns ``(state, net,
    history)``: the final ``PPOState``, the ``ActorCritic`` and one
    record an iteration (``iter``, ``env_steps``, ``time_s``, the mean
    ``pg``, ``vf``, ``ent``, ``ratio`` and ``loss`` over the
    minibatches, ``episodes`` and ``mean_return``).

    Over a sharded pool the policy is placed by ``policy_shardings``
    (``distributed/sharding.py::place_policy``).  Where the plan cuts it
    across the mesh's processes, each process holds its slices of the
    params and of AdamW's ``mu`` and ``nu``, and gathers the whole
    policy ``1 + epochs * minibatches`` times an iteration (once for the
    collect, once a minibatch; ``"policy"`` on ``pool.mesh.log``).  The
    returned ``state.params`` are whole (one gather more, at the end);
    ``state.opt`` stays this process's slices."""
    check_device_pool(pool, "train_device (use train_host)")
    dev = pool.device
    net = ActorCritic(pool.spec, hidden=hidden)
    key, k_init, k_pool = random.split(random.PRNGKey(seed, device=dev), 3)
    params = net.init(k_init)
    mesh = getattr(pool, "mesh", None)
    plan = None
    if mesh is not None:
        params, plan = place_policy(mesh, params)

    M = pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    total_updates = n_iters * cfg.epochs * cfg.minibatches
    opt, update = make_ppo_update(net, cfg, total_updates, mesh, plan)
    state = PPOState(params=params, opt=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))
    rows = getattr(pool, "block_rows", None)

    def collect(params, ps, ts, kc):
        """``num_steps`` recvs with the policy sampling: ``(ps, ts,
        traj)``, traj's leaves ``(num_steps, M, ...)``."""
        traj = None
        for t, k in enumerate(random.split(kc, cfg.num_steps)):
            a, logp, v, _ = net.sample(params, ts.obs, k, rows=rows)
            ps, new_ts = pool.step(ps, a, ts.env_id)
            data = {"obs": ts.obs, "actions": a, "logp": logp, "values": v,
                    "rewards": new_ts.reward, "dones": new_ts.done,
                    "ep_ret": new_ts.episode_return}
            if traj is None:
                traj = alloc_steps(cfg.num_steps, data)
            write_step(traj, t, data)
            ts = new_ts
        return ps, ts, traj

    def train_step(state, ps, ts, kc, ku):
        """One collect and one update; the metrics stay on the device."""
        with torch.no_grad():
            params = gather_policy(mesh, state.params, plan)
            ps, ts, traj = collect(params, ps, ts, kc)
            traj = dict(traj, last_obs=ts.obs)
            if rows is not None:
                traj = _gather_rollout(pool, traj)
            last_v = net.forward(params, traj["last_obs"])[1]
            del params      # each minibatch gathers its own
            adv, ret = gae(traj["rewards"], traj["values"], traj["dones"],
                           last_v, cfg.gamma, cfg.lam)
        rollout = {
            "obs": traj["obs"], "actions": traj["actions"],
            "logp": traj["logp"], "values": traj["values"],
            "adv": adv, "ret": ret,
        }
        state, metrics = update(state, rollout, ku)
        episodes, ep_sum = _episode_metrics(traj["dones"], traj["ep_ret"])
        return state, ps, ts, dict(metrics, episodes=episodes, ep_sum=ep_sum)

    ps, ts = pool.reset(k_pool)
    history: list[dict] = []
    t0 = time.time()
    for it in range(n_iters):
        key, kc, ku = random.split(key, 3)
        state, ps, ts, metrics = train_step(state, ps, ts, kc, ku)
        # the iteration's one host sync: every scalar in one copy
        names = list(metrics)
        values = dict(zip(names, torch.stack(
            [metrics[k].to(torch.float64) for k in names]).tolist()))
        episodes = int(values.pop("episodes"))
        ep_sum = values.pop("ep_sum")
        rec = {"iter": it, "env_steps": (it + 1) * steps_per_iter,
               "time_s": time.time() - t0, **values}
        _record(history, rec, episodes, ep_sum, log_fn)
    return (state.replace(params=gather_policy(mesh, state.params, plan)),
            net, history)


def _gather_rollout(pool: Any, traj: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Every process's rows of a rollout, gathered across a sharded
    pool's processes: ``(num_steps, M/P, ...)`` leaves along dim 1,
    ``last_obs`` ``(M/P, ...)`` along dim 0."""
    return {k: pool.mesh.gather(v, "rollout", dim=0 if k == "last_obs"
                                else 1) for k, v in traj.items()}


# --------------------------------------------------------------------- #
# pipelined device driver: collect and update on two CUDA streams
# --------------------------------------------------------------------- #
def _keep_for(tree: Any, stream: Any) -> None:
    """Tell the caching allocator that ``stream`` reads every CUDA leaf
    of ``tree``, so none is handed out again before ``stream`` is done
    with it, whenever Python drops it."""
    for leaf in tree_leaves(tree):
        if leaf.is_cuda:
            leaf.record_stream(stream)


class _Streams:
    """``train_pipelined``'s two CUDA streams: the collect runs on the
    stream current at the call, the update on a stream of its own.  On
    the CPU there are no streams: every method is a no-op and the two
    halves run in the order they are called."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.collect = torch.cuda.current_stream(dev)
            self.update = torch.cuda.Stream(dev)

    def on_update(self):
        """Context: ops dispatched inside run on the update stream."""
        return (torch.cuda.stream(self.update) if self.cuda
                else contextlib.nullcontext())

    def to_update(self, *trees: Any) -> None:
        """The update stream waits for all the collect stream has
        queued (the rollout, the update's key), and ``trees``, made on
        the collect stream, outlive the update stream's use."""
        if self.cuda:
            self.update.wait_stream(self.collect)
            _keep_for(trees, self.update)

    def updated(self):
        """An event after all the update stream has queued (None on the
        CPU)."""
        return self.update.record_event() if self.cuda else None

    def to_collect(self, event: Any, params: Any) -> None:
        """The collect stream waits for ``event``, the update that made
        ``params`` (None: they were made on the collect stream), and
        ``params`` outlive the collect stream's use."""
        if self.cuda:
            if event is not None:
                self.collect.wait_event(event)
            _keep_for(params, self.collect)


def train_pipelined(pool: Any, cfg: PPOConfig, seed: int = 0,
                    log_fn: Callable[[dict], None] | None = None,
                    hidden: tuple[int, ...] = (256, 128, 64)):
    """Pipelined PPO on a ``repro_torch.make`` device pool, on the
    pool's device.  Returns ``(state, net, history)``, ``history`` with
    ``train_device``'s keys plus ``rho_behavior``.

    A prologue collects rollout 0 behind the initial params; iteration
    t then runs the V-trace update of rollout t and the collect of
    rollout t+1 behind the params from before that update, so the
    consumed rollout is one policy step stale (the JAX package's key
    flow and lag, split for split, so both give the same numbers for a
    seed).  The two halves share no output.  On the card the update is
    dispatched first, on its own CUDA stream, and the collect after it
    on the stream current at the call: the update's device work runs
    while the host dispatches the collect.  Events order them: the
    update of rollout t waits for the collect that wrote it, the collect
    of t+1 for the update that made its params.  The iteration's scalar
    metrics are read (one copy) after both are dispatched.  On the CPU
    the same code runs the halves in turn.

    The JAX package places the learner on one device of the env mesh
    and pushes its params back each iteration (``to_mesh``,
    ``to_learner``).  Here a process's shards share its device, so both
    are the identity; across processes each gathers the rollout and
    runs the update (see the module docstring)."""
    check_device_pool(pool, "train_pipelined (use train_host_pipelined)")
    dev = pool.device
    net = ActorCritic(pool.spec, hidden=hidden)
    key, k_init, k_pool = random.split(random.PRNGKey(seed, device=dev), 3)
    params = net.init(k_init)

    M = pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    opt, vupdate = make_vtrace_ppo_update(
        net, cfg, n_iters * cfg.epochs * cfg.minibatches)
    state = PPOState(params=params, opt=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))

    rows = getattr(pool, "block_rows", None)

    def policy(p, obs, k):
        a, logp, _, _ = net.sample(p, obs, k, rows=rows)
        return a, logp

    collect = build_pipelined_collect_fn(pool, policy, cfg.num_steps)

    def update_step(state, traj, ku):
        """The update and the iteration's scalars, stacked in f64."""
        if rows is not None:
            traj = _gather_rollout(pool, traj)
        state, metrics = vupdate(state, traj, ku)
        episodes, ep_sum = _episode_metrics(traj["dones"], traj["ep_ret"])
        metrics = dict(metrics, episodes=episodes, ep_sum=ep_sum)
        names = list(metrics)
        return state, names, torch.stack(
            [metrics[k].to(torch.float64) for k in names])

    streams = _Streams(dev)
    ps, ts = pool.reset(k_pool)
    key, kc = random.split(key)
    with torch.no_grad():
        ps, ts, traj = collect(ps, state.params, ts, kc)
    made_params = None   # the event after the update that made the params
    history: list[dict] = []
    t0 = time.time()
    for it in range(n_iters):
        key, kc, ku = random.split(key, 3)
        behavior = state.params
        streams.to_update(traj, ku, state)
        with streams.on_update():
            state, names, scalars = update_step(state, traj, ku)
        made_next = streams.updated()
        streams.to_collect(made_params, behavior)
        with torch.no_grad():
            ps, ts, traj = collect(ps, behavior, ts, kc)
        made_params = made_next
        with streams.on_update():   # waits for the update alone
            values = dict(zip(names, scalars.tolist()))
        episodes = int(values.pop("episodes"))
        ep_sum = values.pop("ep_sum")
        rec = {"iter": it, "env_steps": (it + 1) * steps_per_iter,
               "time_s": time.time() - t0, **values}
        _record(history, rec, episodes, ep_sum, log_fn)
    return state, net, history


# --------------------------------------------------------------------- #
# training over a host engine (the paper's Fig. 4 profile path)
# --------------------------------------------------------------------- #
def train_host(env_pool: Any, spec: Any = None, cfg: PPOConfig | None = None,
               seed: int = 0, log_fn: Callable[[dict], None] | None = None,
               hidden: tuple[int, ...] = (256, 128, 64),
               tracer: Tracer | None = None,
               registry: MetricsRegistry | None = None,
               device: torch.device | str | None = None):
    """PPO over a host engine (``ThreadEnvPool``, ``ForLoopEnv``,
    ``SubprocessEnv``) with the policy and update on ``device`` (None:
    the card, wherever the pool is; the paper's layout is envs on the
    CPU and the learner on the card).  Returns ``(state, net, history,
    profile)``; ``profile`` has the paper's four buckets, env_step /
    inference / train / other, in seconds.

    Each bucket is a fenced ``obs/trace.py`` span that closes only after
    its outputs are computed on the card, so no bucket's device work
    leaks into the next.  Pass a ``tracer`` to also get the per-span
    Chrome trace; a ``registry`` receives each iteration record as
    ``ppo_*`` metrics.  The key flow is the JAX package's: one split for
    the init, then one per sample step and one per update."""
    if spec is None:
        spec = env_pool.spec
    if cfg is None:
        cfg = PPOConfig()
    dev = resolve_device(device)
    net = ActorCritic(spec, hidden=hidden)
    key, k_init = random.split(random.PRNGKey(seed, device=dev))
    params = net.init(k_init)

    M = env_pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    opt, update = make_ppo_update(net, cfg,
                                  n_iters * cfg.epochs * cfg.minibatches)
    state = PPOState(params=params, opt=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))

    env_pool.async_reset()
    out = env_pool.recv()

    tr = tracer if tracer is not None else Tracer()
    history: list[dict] = []
    t_start = time.time()
    for it in range(n_iters):
        traj: dict[str, list] = {k: [] for k in (
            "obs", "actions", "logp", "values", "rewards", "dones",
            "ep_ret")}
        for _ in range(cfg.num_steps):
            with tr.span("inference") as sp, torch.no_grad():
                key, ks = random.split(key)
                obs = out["obs"].to(dev)
                a, logp, v, _ = net.sample(state.params, obs, ks)
                sp.fence((a, logp, v))
                a_host = a.cpu()
            with tr.span("env_step"):
                new_out = env_pool.step(a_host, out["env_id"])
            with tr.span("other"):
                for k, x in (("obs", obs), ("actions", a), ("logp", logp),
                             ("values", v),
                             ("rewards", new_out["reward"]),
                             ("dones", new_out["done"]),
                             ("ep_ret", new_out["episode_return"])):
                    traj[k].append(x.to(dev))
                out = new_out

        with tr.span("other") as sp, torch.no_grad():  # GAE belongs here
            stacked = {k: torch.stack(v) for k, v in traj.items()}
            last_v = net.forward(state.params, out["obs"].to(dev))[1]
            adv, ret = gae(stacked["rewards"], stacked["values"],
                           stacked["dones"], last_v, cfg.gamma, cfg.lam)
            rollout = {k: stacked[k] for k in ("obs", "actions", "logp",
                                                "values")}
            rollout.update(adv=adv, ret=ret)
            sp.fence((adv, ret))
        with tr.span("train") as sp:
            key, ku = random.split(key)
            state, metrics = update(state, rollout, ku)
            sp.fence(metrics["loss"])

        episodes, ep_sum = _episode_metrics(stacked["dones"],
                                            stacked["ep_ret"])
        rec = {"iter": it, "env_steps": (it + 1) * steps_per_iter,
               "time_s": time.time() - t_start,
               **{k: float(v) for k, v in metrics.items()}}
        _record(history, rec, int(episodes), float(ep_sum), log_fn,
                registry)
    totals = tr.totals()
    prof = {k: totals.get(k, 0.0)
            for k in ("env_step", "inference", "train", "other")}
    return state, net, history, prof


# --------------------------------------------------------------------- #
# pipelined host driver: actor thread -> StateBufferQueue -> learner
# --------------------------------------------------------------------- #
def train_host_pipelined(env_pool: Any, spec: Any = None,
                         cfg: PPOConfig | None = None, seed: int = 0,
                         log_fn: Callable[[dict], None] | None = None,
                         hidden: tuple[int, ...] = (256, 128, 64),
                         tracer: Tracer | None = None,
                         registry: MetricsRegistry | None = None,
                         device: torch.device | str | None = None):
    """The pipelined driver over a host engine (``ThreadEnvPool``,
    ``ForLoopEnv``, ``SubprocessEnv``), the paper's Appendix D queues on
    a hot path, with the policy and update on ``device`` (None: the
    card, wherever the pool is).

    An actor thread loops ``sample -> step`` behind the latest params
    the learner has published and writes every served batch into a
    ``StateBufferQueue`` with ``put_batch``.  The learner ``take``s
    ``num_steps`` blocks, stacks them on ``device`` and runs
    ``make_vtrace_ppo_update`` (behavior log-probs from the actor,
    values and target log-probs recomputed under the current params).
    The ring's bounded occupancy is the backpressure that bounds the
    actor's lead, and with it the policy lag.  Only the first
    iteration's blocks are all sampled behind the initial params; later
    ones depend on when the learner publishes.

    Returns ``(state, net, history, profile)``; the profile buckets are
    ``actor_wait`` (the learner blocked on the queue: env stepping that
    did not overlap), ``train`` and ``other``, fenced ``obs/trace.py``
    spans.  An actor exception surfaces from the learner as
    ``RuntimeError("pipelined actor thread died")``."""
    if spec is None:
        spec = env_pool.spec
    if cfg is None:
        cfg = PPOConfig()
    dev = resolve_device(device)
    net = ActorCritic(spec, hidden=hidden)
    key, k_init = random.split(random.PRNGKey(seed, device=dev))
    params = net.init(k_init)

    M = env_pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    opt, update = make_vtrace_ppo_update(
        net, cfg, n_iters * cfg.epochs * cfg.minibatches)
    state = PPOState(params=params, opt=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))

    obs_dt = numpy_dtype(spec.obs_spec.dtype)
    fields = {
        "obs": (tuple(spec.obs_spec.shape), obs_dt),
        "next_obs": (tuple(spec.obs_spec.shape), obs_dt),
        "actions": (tuple(spec.act_spec.shape),
                    numpy_dtype(spec.act_spec.dtype)),
        "logp": ((), np.float32),
        "rewards": ((), np.float32),
        "dones": ((), np.bool_),
        "ep_ret": ((), np.float32),
    }
    queue = StateBufferQueue(fields, M, env_pool.num_envs)

    # the behavior params: written by the learner, read by the actor (a
    # dict-slot swap is atomic under the GIL; the update makes new
    # tensors, so the ones the actor holds stay as they were)
    published = {"params": state.params}
    stop = threading.Event()
    failure: list[BaseException] = []

    def actor():
        try:
            akey = random.PRNGKey(seed + 1, device=dev)
            env_pool.async_reset()
            out = env_pool.recv()
            while not stop.is_set():
                akey, ks = random.split(akey)
                with torch.no_grad():
                    a, logp, _, _ = net.sample(published["params"],
                                               out["obs"].to(dev), ks)
                a_host = a.cpu()
                new_out = env_pool.step(a_host, out["env_id"])
                batch = {
                    "obs": out["obs"].cpu().numpy(),
                    "next_obs": new_out["obs"].cpu().numpy(),
                    "actions": a_host.numpy(),
                    "logp": logp.cpu().numpy(),
                    "rewards": new_out["reward"].cpu().numpy(),
                    "dones": new_out["done"].cpu().numpy(),
                    "ep_ret": new_out["episode_return"].cpu().numpy(),
                }
                while not stop.is_set():
                    try:
                        # re-check stop between waits, so shutdown cannot
                        # deadlock against a full ring
                        queue.put_batch(batch, timeout=0.1)
                        break
                    except TimeoutError:
                        continue
                out = new_out
        except Exception as e:  # the learner raises it
            failure.append(e)
            stop.set()

    thread = threading.Thread(target=actor, daemon=True)
    thread.start()

    tr = tracer if tracer is not None else Tracer()
    history: list[dict] = []
    t_start = time.time()
    try:
        for it in range(n_iters):
            with tr.span("actor_wait"):
                blocks = []
                for _ in range(cfg.num_steps):
                    while True:
                        if failure:
                            raise RuntimeError(
                                "pipelined actor thread died") from failure[0]
                        try:
                            blocks.append(queue.take(timeout=5.0))
                            break
                        except TimeoutError:
                            continue

            with tr.span("other") as sp:
                traj = {k: torch.from_numpy(np.stack([b[k] for b in blocks]))
                        .to(dev) for k in ("obs", "actions", "logp",
                                           "rewards", "dones", "ep_ret")}
                traj["last_obs"] = torch.from_numpy(
                    blocks[-1]["next_obs"]).to(dev)
                sp.fence(traj)

            with tr.span("train") as sp:
                key, ku = random.split(key)
                state, metrics = update(state, traj, ku)
                sp.fence(metrics["loss"])
                published["params"] = state.params

            dones = np.stack([b["dones"] for b in blocks])
            rets = np.stack([b["ep_ret"] for b in blocks])[dones]
            rec = {"iter": it, "env_steps": (it + 1) * steps_per_iter,
                   "time_s": time.time() - t_start,
                   **{k: float(v) for k, v in metrics.items()}}
            _record(history, rec, int(rets.size), float(rets.sum()),
                    log_fn, registry)
    finally:
        stop.set()
        thread.join(timeout=10.0)
    totals = tr.totals()
    prof = {k: totals.get(k, 0.0) for k in ("actor_wait", "train", "other")}
    return state, net, history, prof


# --------------------------------------------------------------------- #
# engine-agnostic entry (core/protocol.py dispatch)
# --------------------------------------------------------------------- #
def train(pool: Any, cfg: PPOConfig, seed: int = 0,
          log_fn: Callable[[dict], None] | None = None,
          hidden: tuple[int, ...] = (256, 128, 64)):
    """PPO over any engine: ``train_device`` for the device engine
    (``is_functional``), ``train_host`` for a host engine, the learner
    on the pool's device either way.  Returns ``(state, net,
    history)``; call ``train_host`` for its Fig. 4 buckets or to put
    the learner elsewhere."""
    if is_functional(pool):
        return train_device(pool, cfg, seed=seed, log_fn=log_fn,
                            hidden=hidden)
    state, net, history, _ = train_host(pool, pool.spec, cfg, seed=seed,
                                        log_fn=log_fn, hidden=hidden,
                                        device=pool.device)
    return state, net, history


def train_disaggregated(pool: Any, cfg: PPOConfig, seed: int = 0,
                        log_fn: Callable[[dict], None] | None = None,
                        hidden: tuple[int, ...] = (256, 128, 64),
                        learner_process: int | None = None):
    """Actor/learner disaggregation across the processes of a
    ``torch.distributed`` job (the SRL/Spreeze split).  Every process
    calls it with the same arguments and its own pool object, made on a
    mesh that leaves out the learner
    (``distributed.sharding.disaggregated_env_mesh``); the role decides
    what a process runs.

    * The env processes (all but ``learner_process``, default the last)
      drive ``pool``: the pipelined collect of ``train_pipelined``.
    * The learner runs the V-trace update (``make_vtrace_ppo_update``)
      on its own device, the pool's device of its process.
    * They meet at ``host_broadcast``: rollout t crosses env -> learner
      while the env processes collect t+1 behind the current params,
      and the updated params (with the metrics) cross back.  The
      consumed rollout is one policy step stale, as in
      ``train_pipelined``, with its key flow, split for split.

    The env processes hold the params they receive by
    ``policy_shardings`` over the env mesh (``place_policy``: their
    slices where the plan cuts the policy across them) and gather them
    whole once an iteration, for its collect.  The learner holds the
    whole state, as the JAX package's does.

    Returns ``(state, net, history)``; ``history`` is the same on every
    process, ``state`` is the learner's (the env processes return the
    params they last received, whole, and no optimizer state)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import host_broadcast

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() >= 2):
        raise ValueError("train_disaggregated needs >= 2 processes; join "
                         "them with launch.mesh.initialize_multihost()")
    check_device_pool(pool, "train_disaggregated")
    if learner_process is None:
        learner_process = dist.get_world_size() - 1
    is_learner = dist.get_rank() == learner_process
    mesh = pool.mesh
    if learner_process in mesh.ranks:
        raise ValueError("pool mesh overlaps the learner process; build it "
                         "with distributed.sharding.disaggregated_env_mesh")
    env_src = mesh.ranks[0]
    dev = pool.device
    net = ActorCritic(pool.spec, hidden=hidden)
    key, k_init, k_pool = random.split(random.PRNGKey(seed, device=dev), 3)
    # every process starts from the learner's params
    params = host_broadcast(net.init(k_init), learner_process)

    M = pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    opt, vupdate = make_vtrace_ppo_update(
        net, cfg, n_iters * cfg.epochs * cfg.minibatches)
    step0 = torch.zeros((), dtype=torch.int32, device=dev)
    rows = pool.block_rows

    def policy(p, obs, k):
        a, logp, _, _ = net.sample(p, obs, k, rows=rows)
        return a, logp

    collect = build_pipelined_collect_fn(pool, policy, cfg.num_steps)

    def place(params_host):
        """``(local, plan)``: an env process's part of the learner's
        params, on its device."""
        local, plan = place_policy(mesh, params_host)
        return tree_map(lambda x: x.to(dev), local), plan

    def fetch(traj):
        """The env mesh's whole rollout, on the host."""
        if rows is not None:
            traj = _gather_rollout(pool, traj)
        return tree_map(lambda x: x.cpu(), traj)

    traj_host = None
    key, kc0 = random.split(key)
    if is_learner:
        params = tree_map(lambda x: x.to(dev), params)
        state = PPOState(params=params, opt=opt.init(params), step=step0)
    else:
        params, plan = place(params)
        ps, ts = pool.reset(k_pool)
        with torch.no_grad():
            ps, ts, traj = collect(ps, gather_policy(mesh, params, plan), ts,
                                   kc0)
        traj_host = fetch(traj)
    history: list[dict] = []
    t0 = time.time()
    for it in range(n_iters):
        key, kc, ku = random.split(key, 3)
        traj_rx = host_broadcast(
            traj_host if dist.get_rank() == env_src else None, env_src)
        if is_learner:
            state, metrics = vupdate(
                state, tree_map(lambda x: x.to(dev), traj_rx), ku)
            episodes, ep_sum = _episode_metrics(traj_rx["dones"],
                                                traj_rx["ep_ret"])
            metrics = dict(metrics, episodes=episodes, ep_sum=ep_sum)
            names = sorted(metrics)
            back = (state.params, names, torch.stack(
                [metrics[k].to(torch.float64).cpu() for k in names]))
        else:
            # collect t+1 behind the current params while the learner
            # updates on rollout t
            with torch.no_grad():
                ps, ts, traj = collect(ps, gather_policy(mesh, params, plan),
                                       ts, kc)
            back = None
        new_params, names, scalars = host_broadcast(back, learner_process)
        if not is_learner:
            params, plan = place(new_params)
            traj_host = fetch(traj)
        values = dict(zip(names, scalars.tolist()))
        episodes = int(values.pop("episodes"))
        ep_sum = values.pop("ep_sum")
        rec = {"iter": it, "env_steps": (it + 1) * steps_per_iter,
               "time_s": time.time() - t0, **values}
        _record(history, rec, episodes, ep_sum, log_fn)
    if not is_learner:
        state = PPOState(params=gather_policy(mesh, params, plan), opt=None,
                         step=step0)
    return state, net, history


__all__ = [
    "PPOConfig", "PPOState", "make_ppo_update", "make_vtrace_ppo_update",
    "train", "train_device", "train_disaggregated", "train_host",
    "train_host_pipelined", "train_pipelined",
]
