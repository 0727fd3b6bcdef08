"""Atari-like Pong (``repro/envs/atari_like.py``), registered as
``Pong-v5`` and, with the native RGB screen, ``PongClassic-v5``.

Frameskip 4 with a variable step cost (+2 on the step after a point for
the serve animation, +3 on an episode's first step for the ROM reset),
6 discrete actions, first to 21 points ends the episode.  Every emulator
frame splits the lane's key and draws a serve angle, so the dynamics
depend on JAX-exact random bits (``repro_torch.random``).

``obs_mode="gray84"`` renders one raw 84 x 84 uint8 frame; ``"rgb"``
renders the native 210 x 160 x 3 screen.  Rendering is observe-only, so
dynamics and rng are the same in both modes.  ``observe`` already runs
over the lane dim, so in ``rgb`` mode it renders the whole served
block's screens in one ``kernels/image`` call.
"""

from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.core.specs import ArraySpec, EnvSpec
from repro_torch.envs.base import Environment
from repro_torch.kernels.image.ops import pong_render
from repro_torch.kernels.image.ref import RGB_H, RGB_W
from repro_torch.utils.tree import tree_dataclass

H = W = 84
OBS_MODES = ("gray84", "rgb")
PADDLE_LEN = 12
WIN_SCORE = 21


@tree_dataclass
class AtariLikeState:
    ball_x: torch.Tensor       # (N,) f32 in [0, W)
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    paddle_y: torch.Tensor     # agent paddle (right side)
    enemy_y: torch.Tensor      # scripted opponent (left side)
    score_us: torch.Tensor     # (N,) int32
    score_them: torch.Tensor
    just_scored: torch.Tensor  # (N,) bool: a point in the previous step
    t: torch.Tensor            # (N,) int32
    rng: torch.Tensor          # (N, 2) keys
    ep_return: torch.Tensor    # (N,) f32
    reward_acc: torch.Tensor


class AtariLike(Environment):
    """Pong-like game; the name mirrors EnvPool's ``Pong-v5``."""

    def __init__(self, max_episode_steps: int = 2000,
                 obs_mode: str = "gray84"):
        if obs_mode not in OBS_MODES:
            raise ValueError(
                f"unknown obs_mode {obs_mode!r}; known: {OBS_MODES}")
        self.obs_mode = obs_mode
        obs_spec = (
            ArraySpec((H, W), torch.uint8, 0, 255) if obs_mode == "gray84"
            else ArraySpec((RGB_H, RGB_W, 3), torch.uint8, 0, 255)
        )
        self.spec = EnvSpec(
            name="AtariLike-Pong-v5",
            obs_spec=obs_spec,
            act_spec=ArraySpec((), torch.int32, 0, 5),
            max_episode_steps=max_episode_steps,
            min_cost=4,          # frameskip
            max_cost=9,          # frameskip + score + reset animations
        )

    def init_state(self, keys: torch.Tensor) -> AtariLikeState:
        n, dev = keys.shape[0], keys.device
        ks = random.split(keys, 3)
        angle = random.uniform(ks[:, 1], (), -0.7, 0.7)
        side = torch.where(random.bernoulli(ks[:, 2]), 1.0, -1.0)

        def full(value, dtype=torch.float32):
            return torch.full((n,), value, dtype=dtype, device=dev)

        return AtariLikeState(
            ball_x=full(W / 2), ball_y=full(H / 2),
            ball_vx=side * 1.5 * torch.cos(angle),
            ball_vy=1.5 * torch.sin(angle),
            paddle_y=full(H / 2), enemy_y=full(H / 2),
            score_us=full(0, torch.int32), score_them=full(0, torch.int32),
            just_scored=full(False, torch.bool), t=full(0, torch.int32),
            rng=ks[:, 0], ep_return=full(0.0), reward_acc=full(0.0),
        )

    def _render(self, s: AtariLikeState) -> torch.Tensor:
        dev = s.ball_x.device
        ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]

        def e(v):
            return v[:, None, None]

        half = PADDLE_LEN / 2
        ball = ((torch.abs(ys - e(s.ball_y)) <= 1.0)
                & (torch.abs(xs - e(s.ball_x)) <= 1.0))
        pad = (torch.abs(ys - e(s.paddle_y)) <= half) & (xs >= W - 3)
        enemy = (torch.abs(ys - e(s.enemy_y)) <= half) & (xs <= 2)
        return torch.where(ball | pad | enemy, 236, 52).to(torch.uint8)

    def substep(self, s: AtariLikeState, action) -> AtariLikeState:
        """One emulator frame (the screen is rendered lazily in
        ``observe``, once per serve)."""
        half = PADDLE_LEN / 2
        up = (action == 2) | (action == 4)
        down = (action == 3) | (action == 5)
        dy = torch.where(up, -2.0, torch.where(down, 2.0, 0.0))
        paddle_y = torch.clamp(s.paddle_y + dy, half, H - half)
        # scripted opponent tracks the ball at limited speed
        enemy_dy = torch.clamp(s.ball_y - s.enemy_y, -1.6, 1.6)
        enemy_y = torch.clamp(s.enemy_y + enemy_dy, half, H - half)

        bx = s.ball_x + s.ball_vx
        by = s.ball_y + s.ball_vy
        vy = torch.where((by < 1) | (by > H - 2), -s.ball_vy, s.ball_vy)
        by = torch.clamp(by, 1.0, H - 2.0)
        hit_pad = (bx >= W - 4) & (torch.abs(by - paddle_y) <= half + 1)
        hit_enemy = (bx <= 3) & (torch.abs(by - enemy_y) <= half + 1)
        vx = torch.where(hit_pad | hit_enemy, -s.ball_vx * 1.05, s.ball_vx)
        # spin from where the ball meets the paddle
        vy = torch.where(hit_pad, vy + 0.35 * (by - paddle_y) / PADDLE_LEN,
                         vy)
        vy = torch.where(hit_enemy, vy + 0.35 * (by - enemy_y) / PADDLE_LEN,
                         vy)
        bx = torch.clamp(bx, 0.0, float(W - 1))

        we_score = (bx >= W - 1) & ~hit_pad
        they_score = (bx <= 0) & ~hit_enemy
        scored = we_score | they_score
        reward = torch.where(we_score, 1.0, torch.where(they_score, -1.0,
                                                        0.0))

        # ball respawn on score
        keys = random.split(s.rng)
        angle = random.uniform(keys[:, 1], (), -0.7, 0.7)
        serve_vx = torch.where(we_score, -1.5, 1.5) * torch.cos(angle)
        bx = torch.where(scored, W / 2, bx)
        by = torch.where(scored, H / 2, by)
        vx = torch.where(scored, serve_vx, vx)
        vy = torch.where(scored, 1.5 * torch.sin(angle), vy)
        vx = torch.clamp(vx, -3.0, 3.0)
        vy = torch.clamp(vy, -3.0, 3.0)

        return s.replace(
            ball_x=bx, ball_y=by, ball_vx=vx, ball_vy=vy,
            paddle_y=paddle_y, enemy_y=enemy_y,
            score_us=s.score_us + we_score.to(torch.int32),
            score_them=s.score_them + they_score.to(torch.int32),
            just_scored=scored | s.just_scored,
            rng=keys[:, 0],
            reward_acc=s.reward_acc + reward,
        )

    def step_cost(self, s: AtariLikeState, action) -> torch.Tensor:
        serve = torch.where(s.just_scored, 2, 0)      # serve animation
        reboot = torch.where(s.t == 0, 3, 0)          # ROM reset
        return (4 + serve + reboot).to(torch.int32)

    def terminal(self, s: AtariLikeState) -> torch.Tensor:
        return (s.score_us >= WIN_SCORE) | (s.score_them >= WIN_SCORE)

    def observe(self, s: AtariLikeState) -> torch.Tensor:
        if self.obs_mode == "rgb":
            return pong_render(s.ball_x.contiguous(), s.ball_y.contiguous(),
                               s.paddle_y.contiguous(),
                               s.enemy_y.contiguous())
        return self._render(s)

    def pre_step(self, s: AtariLikeState) -> AtariLikeState:
        # clear the score latch after step_cost consumed it
        return super().pre_step(s).replace(
            just_scored=torch.zeros_like(s.just_scored))


__all__ = ["AtariLike", "AtariLikeState", "OBS_MODES"]
