"""Classic control (``repro/envs/classic.py``): ``CartPole-v1``,
``MountainCar-v0`` and ``Pendulum-v1``, written over a leading lane dim
N.  Every step costs one substep: the control group, where async and
sync serve the same work.

The float ops follow the JAX package's order; ``cos`` and ``sin`` differ
by an ulp between XLA's and torch's CPU versions, so the float streams
agree to a tolerance and the discrete ones bitwise.
"""

from __future__ import annotations

import math

import torch

from repro_torch import random
from repro_torch.core.specs import ArraySpec, EnvSpec
from repro_torch.envs.base import Environment
from repro_torch.utils.tree import tree_dataclass


def _zeros(n: int, device: torch.device, dtype=torch.float32
           ) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=device)


@tree_dataclass
class CartPoleState:
    x: torch.Tensor          # (N,) f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor          # (N,) int32
    rng: torch.Tensor        # (N, 2) keys
    ep_return: torch.Tensor
    reward_acc: torch.Tensor


class CartPole(Environment):
    """CartPole-v1 dynamics (Sutton & Barto, gym's classic)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    TOTAL_MASS = CART_MASS + POLE_MASS
    LENGTH = 0.5
    POLEMASS_LENGTH = POLE_MASS * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * math.pi / 360

    def __init__(self, max_episode_steps: int = 500):
        self.spec = EnvSpec(
            name="CartPole-v1",
            obs_spec=ArraySpec((4,), torch.float32, -4.8, 4.8),
            act_spec=ArraySpec((), torch.int32, 0, 1),
            max_episode_steps=max_episode_steps,
            min_cost=1,
            max_cost=1,
        )

    def init_state(self, keys: torch.Tensor) -> CartPoleState:
        ks = random.split(keys)
        init = random.uniform(ks[:, 1], (4,), -0.05, 0.05)
        n, dev = keys.shape[0], keys.device
        return CartPoleState(
            x=init[:, 0], x_dot=init[:, 1], theta=init[:, 2],
            theta_dot=init[:, 3], t=_zeros(n, dev, torch.int32),
            rng=ks[:, 0], ep_return=_zeros(n, dev),
            reward_acc=_zeros(n, dev),
        )

    def substep(self, s: CartPoleState, action) -> CartPoleState:
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costh = torch.cos(s.theta)
        sinth = torch.sin(s.theta)
        temp = (force + self.POLEMASS_LENGTH * s.theta_dot ** 2 * sinth) \
            / self.TOTAL_MASS
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.POLE_MASS * costh ** 2
                           / self.TOTAL_MASS))
        x_acc = temp - self.POLEMASS_LENGTH * theta_acc * costh \
            / self.TOTAL_MASS
        return s.replace(
            x=s.x + self.TAU * s.x_dot,
            x_dot=s.x_dot + self.TAU * x_acc,
            theta=s.theta + self.TAU * s.theta_dot,
            theta_dot=s.theta_dot + self.TAU * theta_acc,
            reward_acc=s.reward_acc + 1.0,
        )

    def terminal(self, s: CartPoleState) -> torch.Tensor:
        return (s.x.abs() > self.X_LIMIT) | (s.theta.abs() > self.THETA_LIMIT)

    def observe(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


@tree_dataclass
class MountainCarState:
    pos: torch.Tensor        # (N,) f32
    vel: torch.Tensor
    t: torch.Tensor
    rng: torch.Tensor
    ep_return: torch.Tensor
    reward_acc: torch.Tensor


class MountainCar(Environment):
    """MountainCar-v0: push left, none or right; -1 a step until the car
    reaches the flag at 0.5."""

    def __init__(self, max_episode_steps: int = 200):
        self.spec = EnvSpec(
            name="MountainCar-v0",
            obs_spec=ArraySpec((2,), torch.float32, -1.2, 0.6),
            act_spec=ArraySpec((), torch.int32, 0, 2),
            max_episode_steps=max_episode_steps,
        )

    def init_state(self, keys: torch.Tensor) -> MountainCarState:
        ks = random.split(keys)
        n, dev = keys.shape[0], keys.device
        return MountainCarState(
            pos=random.uniform(ks[:, 1], (), -0.6, -0.4),
            vel=_zeros(n, dev), t=_zeros(n, dev, torch.int32),
            rng=ks[:, 0], ep_return=_zeros(n, dev),
            reward_acc=_zeros(n, dev),
        )

    def substep(self, s: MountainCarState, action) -> MountainCarState:
        vel = s.vel + (action - 1) * 0.001 - torch.cos(3 * s.pos) * 0.0025
        vel = torch.clamp(vel, -0.07, 0.07)
        pos = torch.clamp(s.pos + vel, -1.2, 0.6)
        vel = torch.where((pos <= -1.2) & (vel < 0), 0.0, vel)
        return s.replace(pos=pos, vel=vel, reward_acc=s.reward_acc - 1.0)

    def terminal(self, s: MountainCarState) -> torch.Tensor:
        return (s.pos >= 0.5) & (s.vel >= 0.0)

    def observe(self, s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.pos, s.vel], dim=-1)


@tree_dataclass
class PendulumState:
    theta: torch.Tensor      # (N,) f32
    theta_dot: torch.Tensor
    t: torch.Tensor
    rng: torch.Tensor
    ep_return: torch.Tensor
    reward_acc: torch.Tensor


class Pendulum(Environment):
    """Pendulum-v1: swing up a torque-limited pendulum (continuous
    action); never terminates, truncated at ``max_episode_steps``."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, max_episode_steps: int = 200):
        self.spec = EnvSpec(
            name="Pendulum-v1",
            obs_spec=ArraySpec((3,), torch.float32, -8.0, 8.0),
            act_spec=ArraySpec((1,), torch.float32, -2.0, 2.0),
            max_episode_steps=max_episode_steps,
        )

    def init_state(self, keys: torch.Tensor) -> PendulumState:
        ks = random.split(keys)
        init = random.uniform(ks[:, 1], (2,), -1.0, 1.0)
        n, dev = keys.shape[0], keys.device
        return PendulumState(
            theta=init[:, 0] * math.pi, theta_dot=init[:, 1],
            t=_zeros(n, dev, torch.int32), rng=ks[:, 0],
            ep_return=_zeros(n, dev), reward_acc=_zeros(n, dev),
        )

    def substep(self, s: PendulumState, action) -> PendulumState:
        u = torch.clamp(action[:, 0], -self.MAX_TORQUE, self.MAX_TORQUE)
        th_norm = ((s.theta + math.pi) % (2 * math.pi)) - math.pi
        cost = th_norm ** 2 + 0.1 * s.theta_dot ** 2 + 0.001 * u ** 2
        new_dot = s.theta_dot + (
            3 * self.G / (2 * self.L) * torch.sin(s.theta)
            + 3.0 / (self.M * self.L ** 2) * u
        ) * self.DT
        new_dot = torch.clamp(new_dot, -self.MAX_SPEED, self.MAX_SPEED)
        return s.replace(theta=s.theta + new_dot * self.DT,
                         theta_dot=new_dot, reward_acc=s.reward_acc - cost)

    def terminal(self, s: PendulumState) -> torch.Tensor:
        return torch.zeros_like(s.theta, dtype=torch.bool)

    def observe(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta),
                            s.theta_dot], dim=-1)


__all__ = [
    "CartPole", "CartPoleState", "MountainCar", "MountainCarState",
    "Pendulum", "PendulumState",
]
