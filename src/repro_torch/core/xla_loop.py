"""Rollout collection over the device engine (``repro/core/xla_loop.py``).

The JAX package lowers the whole collect loop into one donated-buffer
``lax.scan``, so the ``PoolState`` stays on the device for the whole
rollout.  Here the loop is eager: one ``pool.step`` and one policy call
a step, the state never leaving the card, and the trajectory written
step by step into tensors allocated once at ``(num_steps, M, ...)``
(PongClassic-v5's obs at N = 1024 and 128 steps are 3.70 GB of uint8,
too much to keep as a list and stack afterwards).  ``DeviceEnvPool``'s
methods return a new ``PoolState`` and never write into the one they
were given, which stands in for donation, so neither
``build_collect_fn`` nor ``build_pipelined_collect_fn`` has a
``donate`` option.  Capturing a step in a CUDA graph is left to a
later slice (ROADMAP B, "outside the kernels").

Step ``t`` of a collect draws with ``random.split(key, num_steps)[t]``,
the key the scan hands its step ``t``.

Over a sharded pool (``MeshEnvPool``) the loops are the same: every
recv block is the one the process holds, the whole M block in solo and
the process's M/P rows across processes, so the trajectory is that
block's.  A policy that draws noise for a block should draw it for the
global block and take the process's rows (``pool.block_rows``; see
``rl/nets.py::ActorCritic.sample``), so the draws do not depend on how
the shards are dealt.

``collect_init`` and ``build_collect_fn`` are engine-agnostic, as in the
JAX package: a host engine (thread, forloop, subprocess) gets a loop
with the same signature and trajectory layout (``ps`` is None), the
policy acting on each block moved to the key's device, where the
trajectory is stacked.  The stepwise baseline and the pipelined
collect are for the device engine only and raise
``ValueError`` on a host pool, as the JAX package's do.  The pipelined
collect allocates a fresh rollout every call, which is what lets two be
in flight (``rl/ppo.py::train_pipelined``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import random
from repro_torch.core.engine import DeviceEnvPool, PoolState
from repro_torch.core.protocol import to_timestep
from repro_torch.core.specs import TimeStep
from repro_torch.utils.tree import tree_leaves, tree_map

PolicyFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


def check_device_pool(pool: Any, what: str) -> DeviceEnvPool:
    """``pool``, which ``what`` needs to be the functional (device)
    engine; a host pool raises ``ValueError``."""
    if not isinstance(pool, DeviceEnvPool):
        raise ValueError(
            f"{what} needs a functional (device-family) engine; "
            f"{type(pool).__name__} is a host engine")
    return pool


def alloc_steps(num_steps: int, tree: Any) -> Any:
    """Empty ``(num_steps, *leaf.shape)`` buffers, one a leaf of ``tree``,
    on the leaf's device and in its dtype."""
    return tree_map(lambda x: x.new_empty((num_steps,) + tuple(x.shape)),
                    tree)


def write_step(buffers: Any, t: int, tree: Any) -> None:
    """Copy every leaf of ``tree`` into row ``t`` of its buffer."""
    for buf, leaf in zip(tree_leaves(buffers), tree_leaves(tree)):
        buf[t].copy_(leaf)


def collect_init(pool: Any, key: torch.Tensor
                 ) -> tuple[PoolState | None, TimeStep]:
    """``(carry, first TimeStep)``: the device engine reset from ``key``
    (``carry`` its ``PoolState``), or a host engine reset (``carry``
    None; an async thread pool through ``async_reset`` and one recv)."""
    if isinstance(pool, DeviceEnvPool):
        return pool.reset(key)
    if pool.batch_size < pool.num_envs:
        pool.async_reset()
        return None, to_timestep(pool.recv())
    return None, to_timestep(pool.reset())


def build_collect_fn(pool: Any, policy_fn: PolicyFn,
                     num_steps: int) -> Callable:
    """Returns ``collect(ps, policy_params, last_ts, key) -> (ps, last_ts,
    trajectory, actions)``: ``trajectory`` stacks the ``num_steps``
    TimeStep blocks the policy acted on (leaves ``(num_steps, M,
    ...)``), ``actions`` what it returned.  ``policy_fn(params, obs,
    key) -> actions``.  Over a host engine ``ps`` is ignored and
    returned as None."""
    if not isinstance(pool, DeviceEnvPool):
        return _host_collect_fn(pool, policy_fn, num_steps)

    def collect(ps: PoolState, params: Any, last_ts: TimeStep,
                key: torch.Tensor):
        keys = random.split(key, num_steps)
        traj = alloc_steps(num_steps, last_ts)
        acts = None
        ts = last_ts
        for t in range(num_steps):
            actions = policy_fn(params, ts.obs, keys[t])
            if acts is None:
                acts = alloc_steps(num_steps, actions)
            write_step(traj, t, ts)
            acts[t] = actions
            ps, ts = pool.step(ps, actions, ts.env_id)
        return ps, ts, traj, acts

    return collect


def _host_collect_fn(pool: Any, policy_fn: PolicyFn, num_steps: int
                     ) -> Callable:
    """``build_collect_fn`` over a host engine: the policy acts on each
    block moved to the key's device, its actions go to the pool as they
    are, and the trajectory is stacked on the key's device."""

    def collect(ps: Any, params: Any, last_ts: Any, key: torch.Tensor):
        del ps
        dev = key.device
        ts = to_timestep(last_ts)
        traj = acts = None
        for t, k in enumerate(random.split(key, num_steps)):
            ts = tree_map(lambda x: x.to(dev), ts)
            actions = policy_fn(params, ts.obs, k)
            if traj is None:
                traj = alloc_steps(num_steps, ts)
                acts = alloc_steps(num_steps, actions)
            write_step(traj, t, ts)
            acts[t] = actions
            ts = to_timestep(pool.step(actions, ts.env_id))
        return None, ts, traj, acts

    return collect


def build_stepwise_collect_fn(pool: DeviceEnvPool, policy_fn: PolicyFn,
                              num_steps: int) -> Callable:
    """``build_collect_fn``'s signature and layout, with the served obs
    copied to the host and back before the policy runs each step: what a
    driver that keeps the batch on the host pays, the baseline the
    device-resident loop is measured against."""
    check_device_pool(pool, "build_stepwise_collect_fn")

    def host_policy(params, obs, key):
        return policy_fn(params, obs.cpu().to(obs.device), key)

    return build_collect_fn(pool, host_policy, num_steps)


def build_pipelined_collect_fn(
        pool: Any,
        policy_fn: Callable[[Any, torch.Tensor, torch.Tensor],
                            tuple[torch.Tensor, torch.Tensor]],
        num_steps: int) -> Callable:
    """Returns ``collect(ps, params, last_ts, key) -> (ps, last_ts,
    rollout)``, the collect half of ``rl/ppo.py::train_pipelined``, for
    the device engine only.

    ``rollout`` is a dict of ``(num_steps, M, ...)`` tensors: ``obs``,
    ``actions``, ``logp`` (the behavior policy's log-prob, recorded at
    collect time), ``rewards``, ``dones``, ``ep_ret``, plus ``last_obs``
    ``(M, ...)`` for the learner's bootstrap value.  ``policy_fn(params,
    obs, key) -> (actions, logp)``.  Every call allocates a fresh
    rollout: the driver keeps two in flight, one being read by the
    update while the next is written."""
    check_device_pool(pool, "build_pipelined_collect_fn")

    def collect(ps: PoolState, params: Any, last_ts: TimeStep,
                key: torch.Tensor):
        rollout = None
        ts = last_ts
        for t, k in enumerate(random.split(key, num_steps)):
            actions, logp = policy_fn(params, ts.obs, k)
            ps, new_ts = pool.step(ps, actions, ts.env_id)
            data = {"obs": ts.obs, "actions": actions, "logp": logp,
                    "rewards": new_ts.reward, "dones": new_ts.done,
                    "ep_ret": new_ts.episode_return}
            if rollout is None:
                rollout = alloc_steps(num_steps, data)
            write_step(rollout, t, data)
            ts = new_ts
        rollout["last_obs"] = ts.obs
        return ps, ts, rollout

    return collect


def build_random_collect_fn(pool: DeviceEnvPool, num_steps: int) -> Callable:
    """Random-action collect loop, the paper's pure-simulation benchmark
    (§4.1: "randomly sampled actions as inputs"): step ``t`` acts with
    ``act_spec.sample(keys[t], (M,))``."""
    spec = pool.spec

    def policy(params, obs, key):
        del params, obs
        return spec.act_spec.sample(key, (pool.batch_size,))

    return build_collect_fn(pool, policy, num_steps)


def frames_per_batch(pool: DeviceEnvPool) -> int:
    """Frames produced by one recv: batch_size steps x frameskip (the
    paper counts Atari FPS with frameskip 4, MuJoCo with 5 substeps)."""
    return pool.batch_size * pool.spec.min_cost


__all__ = [
    "alloc_steps", "build_collect_fn", "build_pipelined_collect_fn",
    "build_random_collect_fn", "build_stepwise_collect_fn",
    "check_device_pool", "collect_init", "frames_per_batch", "write_step",
]
