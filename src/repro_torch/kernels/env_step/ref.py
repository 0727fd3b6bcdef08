"""Plain PyTorch version of the batched Ant-lite physics substep — the
oracle the CUDA kernel (``csrc/env_step.cu``) must match bit for bit on
the card, and the CPU path.

Counterpart of ``repro/kernels/env_step/ref.py``: the same op order as
its ``_substep_core`` (the contact model reads the PRE-update state; the
reward accumulates as ``((acc + fwd) - ctrl) + alive``).  Sums over the
four legs and the eight joints are written out left to right, the order
the kernel uses, so the two agree bitwise on the card.  Against the JAX
package on the CPU they agree to a tolerance only: XLA contracts
``a*b + c`` into fused multiply-adds and its ``cos`` differs from
torch's by an ulp on some inputs.
"""

from __future__ import annotations

import torch

N_JOINTS = 8
DT = 0.01
STATE_DIM = 28  # pos(3) + vel(3) + rot(3) + ang(3) + q(8) + qd(8)


def pack_state(pos, vel, rot, ang, q, qd) -> torch.Tensor:
    """(..., 3+3+3+3+8+8=28) flat state."""
    return torch.cat([pos, vel, rot, ang, q, qd], dim=-1)


def unpack_state(s: torch.Tensor):
    return (s[..., 0:3], s[..., 3:6], s[..., 6:9], s[..., 9:12],
            s[..., 12:20], s[..., 20:28])


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last dim (the kernel's order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _substep_core(pos, vel, rot, ang, q, qd, a):
    """One physics substep on unpacked (..., k) components; returns the
    new components and this substep's reward terms (fwd, ctrl, alive)."""
    # contact model: PRE-update joint state
    hip, knee = q[..., 0::2], q[..., 1::2]
    foot_h = pos[..., 2:3] - (0.2 * torch.cos(hip)
                              + 0.2 * torch.cos(hip + knee))
    contact = (foot_h < 0.05).to(torch.float32)
    hip_vel = qd[..., 0::2]
    thrust = _sum_last(contact * (-hip_vel)) * 0.08
    normal = _sum_last(contact * torch.clamp_min(0.05 - foot_h, 0.0)) * 120.0

    # joint dynamics: torque - spring - damping
    qdd = 18.0 * a - 4.0 * q - 1.2 * qd
    qd = qd + DT * qdd
    q = torch.clamp(q + DT * qd, -1.2, 1.2)

    zero = torch.zeros_like(thrust)
    acc = torch.stack([thrust, zero, -9.81 + normal], dim=-1)
    vel = (vel + DT * acc) * 0.995
    pos = pos + DT * vel
    pos = torch.cat([pos[..., :2], torch.clamp_min(pos[..., 2:3], 0.1)],
                    dim=-1)

    asym = contact[..., 0] + contact[..., 1] - contact[..., 2] \
        - contact[..., 3]
    ang = (ang + DT * torch.stack([0.4 * asym, 0.2 * asym, zero], dim=-1)
           ) * 0.98
    rot = rot + DT * ang

    fwd = vel[..., 0] * DT * 20
    ctrl = 0.5 * _sum_last(a * a) * DT
    alive = 1.0 * DT
    return pos, vel, rot, ang, q, qd, fwd, ctrl, alive


def env_multi_substep_reference(
    state: torch.Tensor,                  # (N, 28) f32
    action: torch.Tensor,                 # (N, 8) f32
    cost: torch.Tensor,                   # (N,) int32 substeps per lane
    reward0: torch.Tensor | None = None,  # (N,) f32 accumulator seed
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane ``n`` advances exactly ``cost[n]`` substeps; every iteration
    steps all lanes and freezes those with ``i >= cost`` by select.  The
    reward continues from ``reward0`` (zeros if None)."""
    state = state.to(torch.float32)
    a = torch.clamp(action.to(torch.float32), -1.0, 1.0)
    if reward0 is None:
        reward0 = torch.zeros(state.shape[:-1], dtype=torch.float32,
                              device=state.device)
    reward = reward0.to(torch.float32)
    trip = int(cost.max()) if cost.numel() else 0
    for i in range(trip):
        pos, vel, rot, ang, q, qd, fwd, ctrl, alive = _substep_core(
            *unpack_state(state), a)
        new_s = pack_state(pos, vel, rot, ang, q, qd)
        new_r = ((reward + fwd) - ctrl) + alive
        m = i < cost
        state = torch.where(m[:, None], new_s, state)
        reward = torch.where(m, new_r, reward)
    return state, reward


__all__ = [
    "DT", "N_JOINTS", "STATE_DIM", "env_multi_substep_reference",
    "pack_state", "unpack_state",
]
