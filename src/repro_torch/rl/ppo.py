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

The JAX package fuses collect and update into one jitted, donated
program and places the policy on the env mesh
(``distributed/sharding.py::policy_shardings``); the port's engine
holds one device, so there is no placement (the sharded engine is
ROADMAP A12).  ``train_pipelined``, ``train_disaggregated`` and the
V-trace update are not ported yet and raise naming their item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import random
from repro_torch.core.registry import resolve_device
from repro_torch.core.xla_loop import (
    alloc_steps,
    check_device_pool,
    write_step,
)
from repro_torch.obs.metrics import MetricsRegistry, publish_history
from repro_torch.obs.trace import Tracer
from repro_torch.optim import adamw, linear_decay
from repro_torch.rl.gae import gae
from repro_torch.rl.nets import ActorCritic
from repro_torch.utils.tree import tree_dataclass, tree_leaves, tree_map


@dataclasses.dataclass
class PPOConfig:
    """The JAX package's ``PPOConfig`` without ``rho_clip`` and
    ``c_clip``, which only its pipelined drivers read (ROADMAP A10)."""

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


def make_ppo_update(net: ActorCritic, cfg: PPOConfig, total_updates: int):
    """``(optimizer, update)``; ``update(state, rollout, key) -> (state,
    metrics)`` runs ``cfg.epochs`` epochs of ``cfg.minibatches``
    minibatches over the ``(T, M, ...)`` rollout leaves ``obs``,
    ``actions``, ``logp``, ``values``, ``adv`` and ``ret``.  Each epoch
    shuffles the ``B = T * M`` samples with ``random.permutation`` and
    takes minibatches of ``B // minibatches``, dropping the tail.  The
    metrics are 0-dim tensors on the device."""
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
                (loss, metrics), grads = grad_fn(state.params, batch)
                params, opt_state = opt.update(grads, state.opt, state.params,
                                               lr_fn(state.step))
                state = PPOState(params, opt_state, state.step + 1)
                losses.append(loss)
                history.append(metrics)
        out = {k: torch.mean(torch.stack([m[k] for m in history]))
               for k in history[0]}
        out["loss"] = torch.mean(torch.stack(losses))
        return state, out

    return opt, update


def make_vtrace_ppo_update(*args: Any, **kwargs: Any):
    """The pipelined learner's V-trace update: not ported yet (A10)."""
    raise NotImplementedError(
        "make_vtrace_ppo_update (V-trace) is not ported yet (ROADMAP A10)")


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
    minibatches, ``episodes`` and ``mean_return``)."""
    check_device_pool(pool, "train_device (use train_host)")
    dev = pool.device
    net = ActorCritic(pool.spec, hidden=hidden)
    key, k_init, k_pool = random.split(random.PRNGKey(seed, device=dev), 3)
    params = net.init(k_init)

    M = pool.batch_size
    steps_per_iter = cfg.num_steps * M
    n_iters = max(1, cfg.total_steps // steps_per_iter)
    total_updates = n_iters * cfg.epochs * cfg.minibatches
    opt, update = make_ppo_update(net, cfg, total_updates)
    state = PPOState(params=params, opt=opt.init(params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))

    def collect(params, ps, ts, kc):
        """``num_steps`` recvs with the policy sampling: ``(ps, ts,
        traj)``, traj's leaves ``(num_steps, M, ...)``."""
        traj = None
        for t, k in enumerate(random.split(kc, cfg.num_steps)):
            a, logp, v, _ = net.sample(params, ts.obs, k)
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
            ps, ts, traj = collect(state.params, ps, ts, kc)
            last_v = net.forward(state.params, ts.obs)[1]
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


def _not_ported(name: str, item: str):
    def driver(*args: Any, **kwargs: Any):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP {item}); train_device and "
            "train_host are")

    driver.__name__ = driver.__qualname__ = name
    driver.__doc__ = f"Not ported yet (ROADMAP {item})."
    return driver


train_pipelined = _not_ported("train_pipelined", "A10")
train_host_pipelined = _not_ported("train_host_pipelined", "A10")
train = _not_ported("train", "A10")
train_disaggregated = _not_ported("train_disaggregated", "A12")


__all__ = [
    "PPOConfig", "PPOState", "make_ppo_update", "make_vtrace_ppo_update",
    "train", "train_device", "train_disaggregated", "train_host",
    "train_host_pipelined", "train_pipelined",
]
