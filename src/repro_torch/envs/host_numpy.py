"""Pure-Python/NumPy host environments — the paper's "Python" baseline
(``repro/envs/host_numpy.py``, the same numpy, so the same streams).

Table 2 of the paper compares single-env speed of the original Python
implementations vs EnvPool's C++ ones.  These classes mirror the batched
envs' dynamics and cost structure but run interpreted, per-step Python —
exactly the overhead profile of gym's Python envs.  Reached through
``repro_torch.make_py``; their specs carry torch dtypes like every spec
of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.host_pool import HostEnv
from repro_torch.core.specs import ArraySpec, EnvSpec


class PyCartPole(HostEnv):
    def __init__(self, seed: int = 0, max_episode_steps: int = 500):
        self.spec = EnvSpec(
            name="CartPole-v1",
            obs_spec=ArraySpec((4,), torch.float32, -4.8, 4.8),
            act_spec=ArraySpec((), torch.int32, 0, 1),
            max_episode_steps=max_episode_steps,
        )
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self._s = None
        self._t = 0
        self._ret = 0.0

    def reset(self):
        self._s = self._rng.uniform(-0.05, 0.05, 4)
        self._t = 0
        self._ret = 0.0
        return self._s.astype(np.float32)

    def step(self, action):
        x, x_dot, th, th_dot = self._s
        force = 10.0 if action == 1 else -10.0
        costh, sinth = math.cos(th), math.sin(th)
        temp = (force + 0.05 * th_dot * th_dot * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (0.5 * (4.0 / 3.0 - 0.1 * costh * costh / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        x += 0.02 * x_dot
        x_dot += 0.02 * x_acc
        th += 0.02 * th_dot
        th_dot += 0.02 * th_acc
        self._s = np.array([x, x_dot, th, th_dot])
        self._t += 1
        self._ret += 1.0
        terminated = abs(x) > 2.4 or abs(th) > 0.2095
        truncated = self._t >= self._max_steps and not terminated
        done = terminated or truncated
        info = {
            "terminated": terminated,
            "truncated": truncated,
            "episode_return": self._ret if done else 0.0,
            "episode_length": self._t if done else 0,
            "step_cost": 1,
        }
        obs = self._s.astype(np.float32)
        if done:
            obs = self.reset()
        return obs, 1.0, done, info


class PyPendulum(HostEnv):
    def __init__(self, seed: int = 0, max_episode_steps: int = 200):
        self.spec = EnvSpec(
            name="Pendulum-v1",
            obs_spec=ArraySpec((3,), torch.float32, -8.0, 8.0),
            act_spec=ArraySpec((1,), torch.float32, -2.0, 2.0),
            max_episode_steps=max_episode_steps,
        )
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self.reset()

    def reset(self):
        self._th = self._rng.uniform(-math.pi, math.pi)
        self._thd = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        self._ret = 0.0
        return self._obs()

    def _obs(self):
        return np.array(
            [math.cos(self._th), math.sin(self._th), self._thd], np.float32
        )

    def step(self, action):
        u = float(np.clip(action[0], -2.0, 2.0))
        th_norm = ((self._th + math.pi) % (2 * math.pi)) - math.pi
        cost = th_norm**2 + 0.1 * self._thd**2 + 0.001 * u**2
        self._thd = np.clip(
            self._thd + (15.0 * math.sin(self._th) + 3.0 * u) * 0.05, -8.0, 8.0
        )
        self._th += self._thd * 0.05
        self._t += 1
        self._ret -= cost
        truncated = self._t >= self._max_steps
        info = {
            "terminated": False,
            "truncated": truncated,
            "episode_return": self._ret if truncated else 0.0,
            "episode_length": self._t if truncated else 0,
            "step_cost": 1,
        }
        obs = self._obs()
        if truncated:
            obs = self.reset()
        return obs, -cost, truncated, info


class PyAtariLike(HostEnv):
    """NumPy port of envs/atari_like.py (frameskip 4, raw 84x84 uint8
    frames; stacking is the engine pipeline's job, mirroring the JAX
    env's raw-frame refactor)."""

    H = W = 84
    PAD = 12

    def __init__(self, seed: int = 0, max_episode_steps: int = 2000):
        self.spec = EnvSpec(
            name="AtariLike-Pong-v5",
            obs_spec=ArraySpec((84, 84), torch.uint8, 0, 255),
            act_spec=ArraySpec((), torch.int32, 0, 5),
            max_episode_steps=max_episode_steps,
            min_cost=4,
            max_cost=9,
        )
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self._ys = np.arange(self.H, dtype=np.float32)[:, None]
        self._xs = np.arange(self.W, dtype=np.float32)[None, :]
        self.reset()

    def reset(self):
        r = self._rng
        angle = r.uniform(-0.7, 0.7)
        side = 1.0 if r.random() < 0.5 else -1.0
        self.bx, self.by = self.W / 2, self.H / 2
        self.vx, self.vy = side * 1.5 * math.cos(angle), 1.5 * math.sin(angle)
        self.py_, self.ey = self.H / 2, self.H / 2
        self.su = self.st = 0
        self.just_scored = False
        self._t = 0
        self._ret = 0.0
        return self._render()

    def _render(self):
        ball = (np.abs(self._ys - self.by) <= 1.0) & (np.abs(self._xs - self.bx) <= 1.0)
        pad = (np.abs(self._ys - self.py_) <= self.PAD / 2) & (self._xs >= self.W - 3)
        enemy = (np.abs(self._ys - self.ey) <= self.PAD / 2) & (self._xs <= 2)
        return np.where(ball | pad | enemy, 236, 52).astype(np.uint8)

    def _frame(self, action):
        dy = -2.0 if action in (2, 4) else (2.0 if action in (3, 5) else 0.0)
        self.py_ = float(np.clip(self.py_ + dy, self.PAD / 2, self.H - self.PAD / 2))
        self.ey = float(
            np.clip(self.ey + np.clip(self.by - self.ey, -1.6, 1.6),
                    self.PAD / 2, self.H - self.PAD / 2)
        )
        bx, by = self.bx + self.vx, self.by + self.vy
        if by < 1 or by > self.H - 2:
            self.vy = -self.vy
        by = float(np.clip(by, 1.0, self.H - 2.0))
        hit_pad = bx >= self.W - 4 and abs(by - self.py_) <= self.PAD / 2 + 1
        hit_enemy = bx <= 3 and abs(by - self.ey) <= self.PAD / 2 + 1
        if hit_pad or hit_enemy:
            self.vx = -self.vx * 1.05
            anchor = self.py_ if hit_pad else self.ey
            self.vy += 0.35 * (by - anchor) / self.PAD
        bx = float(np.clip(bx, 0.0, self.W - 1))
        reward = 0.0
        we = bx >= self.W - 1 and not hit_pad
        they = bx <= 0 and not hit_enemy
        if we or they:
            reward = 1.0 if we else -1.0
            self.su += int(we)
            self.st += int(they)
            self.just_scored = True
            angle = self._rng.uniform(-0.7, 0.7)
            bx, by = self.W / 2, self.H / 2
            self.vx = (-1.5 if we else 1.5) * math.cos(angle)
            self.vy = 1.5 * math.sin(angle)
        self.vx = float(np.clip(self.vx, -3.0, 3.0))
        self.vy = float(np.clip(self.vy, -3.0, 3.0))
        self.bx, self.by = bx, by
        return reward

    def step(self, action):
        cost = 4 + (2 if self.just_scored else 0) + (3 if self._t == 0 else 0)
        self.just_scored = False
        reward = 0.0
        for _ in range(cost):
            reward += self._frame(int(action))
        self._t += 1
        self._ret += reward
        terminated = self.su >= 21 or self.st >= 21
        truncated = self._t >= self._max_steps and not terminated
        done = terminated or truncated
        info = {
            "terminated": terminated,
            "truncated": truncated,
            "episode_return": self._ret if done else 0.0,
            "episode_length": self._t if done else 0,
            "step_cost": cost,
        }
        obs = self._render()
        if done:
            obs = self.reset()
        return obs, reward, done, info


class PyMujocoLike(HostEnv):
    """NumPy port of envs/mujoco_like.py (ant-lite, 5 substeps + contacts)."""

    def __init__(self, seed: int = 0, max_episode_steps: int = 1000):
        self.spec = EnvSpec(
            name="MujocoLike-Ant-v3",
            obs_spec=ArraySpec((29,), torch.float32),
            act_spec=ArraySpec((8,), torch.float32, -1.0, 1.0),
            max_episode_steps=max_episode_steps,
            min_cost=5,
            max_cost=9,
        )
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self.reset()

    def reset(self):
        r = self._rng
        self.pos = np.array([0.0, 0.0, 0.55])
        self.vel = np.zeros(3)
        self.rot = np.zeros(3)
        self.ang = np.zeros(3)
        self.q = r.uniform(-0.1, 0.1, 8)
        self.qd = r.normal(size=8) * 0.05
        self._t = 0
        self._ret = 0.0
        return self._obs()

    def _foot_h(self):
        hip, knee = self.q[0::2], self.q[1::2]
        return self.pos[2] - (0.2 * np.cos(hip) + 0.2 * np.cos(hip + knee))

    def _substep(self, a):
        dt = 0.01
        qdd = 18.0 * a - 4.0 * self.q - 1.2 * self.qd
        self.qd = self.qd + dt * qdd
        self.q = np.clip(self.q + dt * self.qd, -1.2, 1.2)
        foot_h = self._foot_h()
        contact = (foot_h < 0.05).astype(np.float64)
        thrust = float(np.sum(contact * (-self.qd[0::2]))) * 0.08
        normal = float(np.sum(contact * np.maximum(0.05 - foot_h, 0.0))) * 120.0
        self.vel = (self.vel + dt * np.array([thrust, 0.0, -9.81 + normal])) * 0.995
        self.pos = self.pos + dt * self.vel
        self.pos[2] = max(self.pos[2], 0.1)
        asym = contact[0] + contact[1] - contact[2] - contact[3]
        self.ang = (self.ang + dt * np.array([0.4 * asym, 0.2 * asym, 0.0])) * 0.98
        self.rot = self.rot + dt * self.ang
        return (
            self.vel[0] * dt * 20 - 0.5 * float(np.sum(a * a)) * dt + dt
        )

    def _obs(self):
        foot_h = self._foot_h()
        return np.concatenate(
            [
                self.pos[2:], self.rot, self.q, self.vel, self.ang, self.qd,
                [float(np.sum(foot_h < 0.05)), float(np.min(foot_h)),
                 float(np.max(foot_h))],
            ]
        ).astype(np.float32)

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        cost = 5 + int(np.sum(self._foot_h() < 0.05))
        reward = 0.0
        for _ in range(cost):
            reward += self._substep(a)
        self._t += 1
        self._ret += reward
        healthy = 0.2 < self.pos[2] < 1.0 and float(np.max(np.abs(self.rot))) < 1.0
        terminated = not healthy
        truncated = self._t >= self._max_steps and not terminated
        done = terminated or truncated
        info = {
            "terminated": terminated,
            "truncated": truncated,
            "episode_return": self._ret if done else 0.0,
            "episode_length": self._t if done else 0,
            "step_cost": cost,
        }
        obs = self._obs()
        if done:
            obs = self.reset()
        return obs, reward, done, info


__all__ = ["PyAtariLike", "PyCartPole", "PyMujocoLike", "PyPendulum"]
