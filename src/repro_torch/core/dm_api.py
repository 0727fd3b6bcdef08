"""A dm_env-style facade (``repro/core/dm_api.py``, paper Appendix A.2)
over any ``EnvPool``, through ``core.protocol.bind``:

    dm = DmEnv(repro_torch.make("Pong-v5", num_envs=100))
    ts = dm.reset(key)                 # ts.observation.obs, .env_id
    ts = dm.step(actions, ts.observation.env_id)

Under EnvPool's auto-reset the transition that reports ``done`` is LAST
(its reward and discount close the episode; its obs already opens the
next), and the next transition served for that env is FIRST, with
discount 1 and its reward kept.  ``DmEnv`` tracks each env's last
served ``done`` across blocks, async order included.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.protocol import EnvPool, bind


class DmObservation(NamedTuple):
    obs: Any
    env_id: torch.Tensor


class DmTimeStep(NamedTuple):
    step_type: torch.Tensor    # 0 FIRST, 1 MID, 2 LAST
    reward: torch.Tensor
    discount: torch.Tensor
    observation: DmObservation

    def first(self) -> torch.Tensor:
        return self.step_type == 0

    def last(self) -> torch.Tensor:
        return self.step_type == 2


def _convert(ts, first: torch.Tensor, gamma: float = 1.0) -> DmTimeStep:
    """``first`` marks envs whose previous served transition was LAST."""
    step_type = torch.where(ts.done, 2, torch.where(first, 0, 1)).to(
        torch.int32)
    discount = torch.where(ts.terminated, 0.0, gamma).to(torch.float32)
    # a FIRST transition belongs to the fresh episode: full discount
    discount = torch.where(step_type == 0, 1.0, discount)
    return DmTimeStep(step_type=step_type, reward=ts.reward,
                      discount=discount,
                      observation=DmObservation(obs=ts.obs,
                                                env_id=ts.env_id))


class DmEnv:
    """dm_env facade over any EnvPool (sync or async)."""

    def __init__(self, pool: EnvPool, gamma: float = 1.0):
        self.pool = pool
        self.gamma = gamma
        self._bound = None
        self._prev_done = None   # (num_envs,) bool: last served was LAST

    def action_spec(self):
        return self.pool.spec.act_spec

    def observation_spec(self):
        return self.pool.spec.obs_spec

    def reset(self, key: torch.Tensor | None = None) -> DmTimeStep:
        self._bound = bind(self.pool, key=key)
        ts = self._bound.reset()
        self._prev_done = torch.zeros((self.pool.num_envs,), dtype=torch.bool,
                                      device=ts.done.device)
        out = _convert(ts, first=torch.ones_like(ts.done), gamma=self.gamma)
        # a reset block is FIRST by definition, with no reward yet
        return out._replace(step_type=torch.zeros_like(out.step_type),
                            reward=torch.zeros_like(out.reward))

    def step(self, actions: Any, env_id: Any) -> DmTimeStep:
        if self._bound is None:
            raise RuntimeError("call DmEnv.reset() before step()")
        ts = self._bound.step(actions, env_id)
        ids = ts.env_id.long()
        first = self._prev_done.index_select(0, ids)
        self._prev_done = self._prev_done.index_copy(0, ids, ts.done)
        return _convert(ts, first=first, gamma=self.gamma)


__all__ = ["DmEnv", "DmObservation", "DmTimeStep"]
