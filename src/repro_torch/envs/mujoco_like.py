"""MuJoCo-like "ant-lite" locomotion (``repro/envs/mujoco_like.py``),
registered as ``Ant-v3``: an 8-joint quadruped with semi-implicit Euler
integration, 5 base physics substeps per step plus one per leg in ground
contact (the data-dependent solver cost), reward = forward velocity -
control cost + alive bonus, terminal when the torso leaves [0.2, 1.0].

``MujocoLike`` states every lane's dynamics in plain tensor ops;
``MujocoLikeBatch`` (what the engine drives) runs all the substeps of a
recv in ONE ``kernels/env_step`` call.
"""

from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.core.specs import ArraySpec, EnvSpec
from repro_torch.envs.base import Environment
from repro_torch.envs.batch import VmapBatchEnv
from repro_torch.kernels.env_step.ops import env_multi_step
from repro_torch.kernels.env_step.ref import (
    N_JOINTS,
    _substep_core,
    pack_state,
    unpack_state,
)
from repro_torch.utils.tree import tree_dataclass

OBS_DIM = 29


@tree_dataclass
class MujocoLikeState:
    pos: torch.Tensor         # (N, 3) torso x, y, z
    vel: torch.Tensor         # (N, 3)
    rot: torch.Tensor         # (N, 3) roll, pitch, yaw (small-angle)
    ang_vel: torch.Tensor     # (N, 3)
    q: torch.Tensor           # (N, 8) joint angles
    qd: torch.Tensor          # (N, 8) joint velocities
    t: torch.Tensor           # (N,) int32
    rng: torch.Tensor         # (N, 2) keys
    ep_return: torch.Tensor   # (N,) f32
    reward_acc: torch.Tensor  # (N,) f32
    cost_scale: torch.Tensor  # (N,) int32 solver-iteration multiplier


class MujocoLike(Environment):
    """Ant-lite; the name mirrors EnvPool's ``Ant-v3``.

    ``heavy_frac``/``heavy_iters`` make the long-tail cost skew of
    ``AntSkew-v3``: each episode draws a solver-iteration multiplier
    ``cost_scale``, ``heavy_iters`` with probability ``heavy_frac`` and
    else 1, from its init key folded with 7 (no extra randomness drawn,
    so the default is unchanged and every engine agrees on which
    episodes are heavy).  A step then costs up to ``5 + 4 * iters``."""

    def __init__(self, max_episode_steps: int = 1000,
                 heavy_frac: float = 0.0, heavy_iters: int = 4):
        self.heavy_frac = float(heavy_frac)
        self.heavy_iters = int(heavy_iters)
        iters = self.heavy_iters if heavy_frac > 0 else 1
        self.spec = EnvSpec(
            name="MujocoLike-Ant-v3",
            obs_spec=ArraySpec((OBS_DIM,), torch.float32),
            act_spec=ArraySpec((N_JOINTS,), torch.float32, -1.0, 1.0),
            max_episode_steps=max_episode_steps,
            min_cost=5,                # base physics substeps
            max_cost=5 + 4 * iters,    # + contact-solver iterations
        )

    def init_state(self, keys: torch.Tensor) -> MujocoLikeState:
        n, dev = keys.shape[0], keys.device
        ks = random.split(keys, 3)
        q = random.uniform(ks[:, 1], (N_JOINTS,), -0.1, 0.1)
        qd = random.normal(ks[:, 2], (N_JOINTS,)) * 0.05

        def full(value, width=None, dtype=torch.float32):
            shape = (n,) if width is None else (n, width)
            return torch.full(shape, value, dtype=dtype, device=dev)

        pos = full(0.0, 3)
        pos[:, 2] = 0.55
        cost_scale = full(1, dtype=torch.int32)
        # a uniform draw is never below 0, so without skew the draw (two
        # threefry hashes over every lane of each auto-reset) is skipped
        if self.heavy_frac > 0:
            heavy = random.uniform(random.fold_in(keys, 7)) < self.heavy_frac
            cost_scale = torch.where(heavy, self.heavy_iters, cost_scale)
        return MujocoLikeState(
            pos=pos, vel=full(0.0, 3), rot=full(0.0, 3),
            ang_vel=full(0.0, 3), q=q, qd=qd,
            t=full(0, dtype=torch.int32), rng=ks[:, 0],
            ep_return=full(0.0), reward_acc=full(0.0),
            cost_scale=cost_scale,
        )

    @staticmethod
    def foot_height(s: MujocoLikeState) -> torch.Tensor:
        """(N, 4) height of each foot: legs hang ``0.2 cos(hip) +
        0.2 cos(hip + knee)`` below the torso."""
        hip, knee = s.q[:, 0::2], s.q[:, 1::2]
        drop = 0.2 * torch.cos(hip) + 0.2 * torch.cos(hip + knee)
        return s.pos[:, 2:3] - drop

    def n_contacts(self, s: MujocoLikeState) -> torch.Tensor:
        return (self.foot_height(s) < 0.05).sum(dim=-1).to(torch.int32)

    def substep(self, s: MujocoLikeState, action) -> MujocoLikeState:
        a = torch.clamp(action.to(torch.float32), -1.0, 1.0)
        pos, vel, rot, ang, q, qd, fwd, ctrl, alive = _substep_core(
            s.pos, s.vel, s.rot, s.ang_vel, s.q, s.qd, a)
        return s.replace(pos=pos, vel=vel, rot=rot, ang_vel=ang, q=q, qd=qd,
                         reward_acc=((s.reward_acc + fwd) - ctrl) + alive)

    def step_cost(self, s: MujocoLikeState, action) -> torch.Tensor:
        return 5 + self.n_contacts(s) * s.cost_scale

    def terminal(self, s: MujocoLikeState) -> torch.Tensor:
        z = s.pos[:, 2]
        healthy = (z > 0.2) & (z < 1.0) & (s.rot.abs().amax(dim=-1) < 1.0)
        return ~healthy

    def observe(self, s: MujocoLikeState) -> torch.Tensor:
        foot_h = self.foot_height(s)
        contacts = torch.stack([
            (foot_h < 0.05).sum(dim=-1).to(torch.float32),
            foot_h.amin(dim=-1),
            foot_h.amax(dim=-1),
        ], dim=-1)
        return torch.cat([s.pos[:, 2:], s.rot, s.q, s.vel, s.ang_vel, s.qd,
                          contacts], dim=-1).to(torch.float32)

    def as_batch(self) -> "MujocoLikeBatch":
        return MujocoLikeBatch(self)


class MujocoLikeBatch(VmapBatchEnv):
    """The engine's view of MujocoLike: the physics scalars packed into
    the kernel's (N, 28) layout and every data-dependent substep of a
    recv run in one ``env_multi_step`` call (the CUDA kernel for CUDA
    tensors, its plain version on the CPU).  Masked mode's tick, one
    substep of every lane, is the same call at ``n_sub = 1``.
    Bookkeeping stays in the env class."""

    @staticmethod
    def _physics(s: MujocoLikeState, actions: torch.Tensor,
                 costs: torch.Tensor | None, n_sub: int
                 ) -> MujocoLikeState:
        flat = pack_state(s.pos, s.vel, s.rot, s.ang_vel, s.q, s.qd)
        flat, reward = env_multi_step(
            flat.contiguous(), actions.to(torch.float32).contiguous(),
            None if costs is None else costs.to(torch.int32).contiguous(),
            s.reward_acc.contiguous(), n_sub=n_sub,
        )
        pos, vel, rot, ang, q, qd = unpack_state(flat)
        return s.replace(pos=pos, vel=vel, rot=rot, ang_vel=ang, q=q, qd=qd,
                         reward_acc=reward)

    def v_substep(self, s: MujocoLikeState, actions: torch.Tensor
                  ) -> MujocoLikeState:
        return self._physics(s, actions, None, 1)

    def v_multi_substep(self, s: MujocoLikeState, actions: torch.Tensor,
                        costs: torch.Tensor) -> MujocoLikeState:
        return self._physics(s, actions, costs, self.spec.max_cost)


__all__ = ["MujocoLike", "MujocoLikeBatch", "MujocoLikeState", "OBS_DIM"]
