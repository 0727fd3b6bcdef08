"""Environment interface over a leading lane dimension
(``repro/envs/base.py``).

An environment is a state machine whose methods take and return
``tree_dataclass`` states with a leading lane dim N — the batch is
written out where the JAX package ``vmap``\\ s a per-lane function.  The
cost model is first-class: ``step_cost(state, action)`` is the number of
substeps the next step will run, which the async scheduler reads.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random
from repro_torch.core.specs import EnvSpec, TimeStep
from repro_torch.utils.tree import tree_where


class Environment:
    """Base class; subclasses implement the primitive methods, each over
    N lanes at once."""

    spec: EnvSpec

    def init_state(self, keys: torch.Tensor) -> Any:
        """Fresh episode states from (N, 2) keys; must hold fields ``t``,
        ``rng``, ``ep_return`` and ``reward_acc``."""
        raise NotImplementedError

    def substep(self, state: Any, action: Any) -> Any:
        """Advance every lane one work unit, accumulating reward into
        ``state.reward_acc``."""
        raise NotImplementedError

    def step_cost(self, state: Any, action: Any) -> torch.Tensor:
        """(N,) int32 predicted work units of the next step; a constant
        ``spec.min_cost`` unless the env says otherwise."""
        return torch.full_like(state.t, self.spec.min_cost,
                               dtype=torch.int32)

    def terminal(self, state: Any) -> torch.Tensor:
        """(N,) bool: the episode terminated (not truncation)."""
        raise NotImplementedError

    def observe(self, state: Any) -> Any:
        raise NotImplementedError

    def pre_step(self, state: Any) -> Any:
        """Run after ``step_cost`` is read, before the substeps: clears
        the per-step reward accumulator."""
        return state.replace(reward_acc=torch.zeros_like(state.reward_acc))

    def finalize_step(self, state: Any, cost: torch.Tensor
                      ) -> tuple[Any, TimeStep]:
        """Tail of a step after its substeps: episode bookkeeping,
        termination and auto-reset (the returned state of a finished lane
        is the next episode's first state).

        The TimeStep's ``obs`` is left as None.  The JAX package builds
        ``observe(state)`` here and lets XLA drop it, since the engine
        observes the post-step states itself; eager PyTorch would run it,
        which for the Pong screen is a second 210 x 160 x 3 render per
        recv."""
        spec = self.spec
        state = state.replace(t=state.t + 1)
        reward = state.reward_acc
        terminated = self.terminal(state)
        truncated = (state.t >= spec.max_episode_steps) & ~terminated
        done = terminated | truncated

        ep_return = state.ep_return + reward
        ep_length = state.t

        keys = random.split(state.rng)
        state = state.replace(rng=keys[:, 0], ep_return=ep_return)
        fresh = self.init_state(keys[:, 1])
        state = tree_where(done, fresh, state)

        ts = TimeStep(
            obs=None,
            reward=reward.to(torch.float32),
            done=done,
            terminated=terminated,
            truncated=truncated,
            env_id=torch.zeros_like(cost),  # filled by the pool
            episode_return=torch.where(done, ep_return, 0.0).to(
                torch.float32),
            episode_length=torch.where(done, ep_length, 0).to(torch.int32),
            step_cost=cost,
        )
        return state, ts

    def as_batch(self):
        """The batched view engines drive (``envs/batch.py``); envs with
        a kernel-backed hot path override this."""
        from repro_torch.envs.batch import VmapBatchEnv

        return VmapBatchEnv(self)


__all__ = ["Environment"]
