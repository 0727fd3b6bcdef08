"""Environment specs and timestep containers (``repro/core/specs.py``).

Every environment declares its observation/action spaces so engines can
size their buffers without stepping anything (EnvPool's ``EnvSpec``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import random
from repro_torch.utils.tree import tree_dataclass


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape/dtype/bounds of a single array field."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    minimum: float | None = None
    maximum: float | None = None
    name: str = ""

    def zeros(self, leading: tuple[int, ...] = (),
              device: torch.device | str | None = None) -> torch.Tensor:
        return torch.zeros(leading + self.shape, dtype=self.dtype,
                           device=device)

    def sample(self, key: torch.Tensor, leading: tuple[int, ...] = ()
               ) -> torch.Tensor:
        """A uniform draw from the spec on ``key``'s device, bitwise the
        JAX package's ``sample_jax``: integers in ``[minimum, maximum]``
        (default ``[0, 1]``), floats in ``[minimum, maximum)`` (default
        ``[-1, 1)``)."""
        shape = tuple(leading) + self.shape
        if not self.dtype.is_floating_point:
            lo = int(self.minimum) if self.minimum is not None else 0
            hi = int(self.maximum) if self.maximum is not None else 1
            return random.randint(key, shape, lo, hi + 1).to(self.dtype)
        lo = self.minimum if self.minimum is not None else -1.0
        hi = self.maximum if self.maximum is not None else 1.0
        return random.uniform(key, shape, lo, hi).to(self.dtype)


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static description of an environment."""

    name: str
    obs_spec: ArraySpec
    act_spec: ArraySpec
    max_episode_steps: int = 1000
    # every step consumes between min_cost and max_cost work units
    # (substeps); the async scheduler uses the per-step predicted cost
    min_cost: int = 1
    max_cost: int = 1

    @property
    def num_actions(self) -> int:
        if self.act_spec.dtype.is_floating_point:
            raise ValueError(
                f"{self.name}: continuous action space has no num_actions")
        return int(self.act_spec.maximum) + 1


@tree_dataclass
class TimeStep:
    """One batched environment transition; ``env_id`` routes actions
    back in async mode (EnvPool's ``info["env_id"]``)."""

    obs: Any
    reward: torch.Tensor
    done: torch.Tensor           # terminated | truncated
    terminated: torch.Tensor
    truncated: torch.Tensor
    env_id: torch.Tensor
    episode_return: torch.Tensor  # return of the episode that just ended
    episode_length: torch.Tensor
    step_cost: torch.Tensor       # work units this step consumed

    @property
    def info(self) -> dict[str, torch.Tensor]:
        return {
            "env_id": self.env_id,
            "episode_return": self.episode_return,
            "episode_length": self.episode_length,
            "terminated": self.terminated,
            "truncated": self.truncated,
            "step_cost": self.step_cost,
        }


def zero_timestep(spec: EnvSpec, batch: int,
                  device: torch.device | str | None = None) -> TimeStep:
    """An empty TimeStep block of ``batch`` rows."""
    def z(dtype):
        return torch.zeros((batch,), dtype=dtype, device=device)

    return TimeStep(
        obs=spec.obs_spec.zeros((batch,), device),
        reward=z(torch.float32), done=z(torch.bool),
        terminated=z(torch.bool), truncated=z(torch.bool),
        env_id=z(torch.int32), episode_return=z(torch.float32),
        episode_length=z(torch.int32), step_cost=z(torch.int32),
    )


__all__ = ["ArraySpec", "EnvSpec", "TimeStep", "zero_timestep"]
