"""Batched env layer (``repro/envs/batch.py``).

``BatchEnvironment`` is the unit engines drive: every method takes and
returns states with a leading N dim, and ``v_step`` advances a whole
block — per-lane data-dependent substep counts included — in one pass.
``VmapBatchEnv`` is the generic adapter over an ``Environment``; its
name follows the JAX package, where it ``vmap``\\ s per-lane methods.
Here the env's methods are already batched, so it forwards to them.
Natively batched envs (``MujocoLikeBatch``) override the hot primitives
with kernels.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.specs import EnvSpec, TimeStep
from repro_torch.envs.base import Environment
from repro_torch.utils.tree import tree_where


class BatchEnvironment:
    """Natively batched env interface: leading dim N on every method."""

    spec: EnvSpec

    def v_init_state(self, keys: torch.Tensor) -> Any:
        raise NotImplementedError

    def v_substep(self, states: Any, actions: Any) -> Any:
        raise NotImplementedError

    def v_step_cost(self, states: Any, actions: Any) -> torch.Tensor:
        raise NotImplementedError

    def v_pre_step(self, states: Any) -> Any:
        raise NotImplementedError

    def v_observe(self, states: Any) -> Any:
        raise NotImplementedError

    def v_finalize(self, states: Any, costs: torch.Tensor
                   ) -> tuple[Any, TimeStep]:
        raise NotImplementedError

    def v_multi_substep(self, states: Any, actions: Any,
                        costs: torch.Tensor) -> Any:
        """Advance lane ``n`` by ``costs[n]`` substeps: every iteration
        steps all lanes and freezes those with ``i >= costs`` by select,
        so frozen lanes keep their state (their rng included) — the
        batching rule JAX applies to a vmapped per-lane ``while_loop``.
        The trip count is read on the host (one sync per call)."""
        trip = int(costs.max()) if costs.numel() else 0
        for i in range(trip):
            states = tree_where(i < costs, self.v_substep(states, actions),
                                states)
        return states

    def v_step(self, states: Any, actions: Any,
               do: torch.Tensor | None = None) -> tuple[Any, TimeStep]:
        """One full batched env step: per-lane cost, fused substeps,
        bookkeeping, auto-reset.  ``do=False`` lanes are frozen (zero
        substeps, state restored)."""
        spec = self.spec
        orig = states
        costs = torch.clamp(self.v_step_cost(states, actions),
                            spec.min_cost, spec.max_cost).to(torch.int32)
        if do is None:
            do = torch.ones_like(costs, dtype=torch.bool)
        costs = torch.where(do, costs, 0).to(torch.int32)
        states = self.v_pre_step(states)
        states = self.v_multi_substep(states, actions, costs)
        states, ts = self.v_finalize(states, costs)
        return tree_where(do, states, orig), ts


class VmapBatchEnv(BatchEnvironment):
    """Generic adapter: forwards to an ``Environment``'s batched
    methods."""

    def __init__(self, env: Environment):
        self.env = env
        self.spec = env.spec

    def v_init_state(self, keys):
        return self.env.init_state(keys)

    def v_substep(self, states, actions):
        return self.env.substep(states, actions)

    def v_step_cost(self, states, actions):
        return self.env.step_cost(states, actions)

    def v_pre_step(self, states):
        return self.env.pre_step(states)

    def v_observe(self, states):
        return self.env.observe(states)

    def v_finalize(self, states, costs):
        return self.env.finalize_step(states, costs)


def as_batch_env(env: Environment | BatchEnvironment,
                 native: bool | None = None) -> BatchEnvironment:
    """The env's batched view.  ``native=None`` takes its own (the
    kernel-backed one, where it has one); ``False`` the generic
    ``VmapBatchEnv``; ``True`` requires a non-generic view and raises if
    the env has none."""
    if isinstance(env, BatchEnvironment):
        return env
    if native is False:
        return VmapBatchEnv(env)
    benv = env.as_batch()
    if native is True and type(benv) is VmapBatchEnv:
        raise ValueError(
            f"{type(env).__name__} has no natively batched implementation")
    return benv


__all__ = ["BatchEnvironment", "VmapBatchEnv", "as_batch_env"]
