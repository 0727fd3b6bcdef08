"""Actor-critic policy networks (``repro/rl/nets.py``): a shared trunk,
the Nature-CNN for pixel obs and an ELU MLP for state obs, as in the
rl_games/CleanRL configurations of the paper's appendix tables.

As in ``rl/policy_lm.py``, parameters are a dict of tensors and the
methods are functions over them.  ``init`` draws from the port's
JAX-exact ``random`` in the JAX package's key layout, so a seed gives
both packages the same weights to ``normal``'s tolerance.  Layouts
differ in one place: a conv weight is OIHW here (``F.conv2d``) and HWIO
there.  The trunk flattens the conv stack's output in NHWC order, as
the JAX package does, so ``fc.w`` has the same rows in both.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.core.device import resolve_device
from repro_torch.core.specs import EnvSpec


def _f32_log(x: float) -> float:
    """``jnp.log(x)`` of a Python float: the f32 log of f32(x), correctly
    rounded (numpy's f32 log is an ulp off at 2 pi)."""
    return float(np.float32(math.log(np.float32(x))))


LOG_2PI = _f32_log(2 * math.pi)
LOG_2PI_E = _f32_log(2 * math.pi * math.e)


def _dense(key: torch.Tensor, din: int, dout: int,
           scale: float | None = None) -> dict[str, torch.Tensor]:
    scale = scale if scale is not None else math.sqrt(2.0 / din)
    k1 = random.split(key)[0]
    return {"w": random.normal(k1, (din, dout)) * scale,
            "b": torch.zeros((dout,), dtype=torch.float32,
                             device=key.device)}


def _apply_dense(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _conv(key: torch.Tensor, cin: int, cout: int, kh: int, kw: int
          ) -> dict[str, torch.Tensor]:
    """Drawn at the JAX package's HWIO shape, stored OIHW."""
    scale = math.sqrt(2.0 / (cin * kh * kw))
    w = random.normal(key, (kh, kw, cin, cout)) * scale
    return {"w": w.permute(3, 2, 0, 1).contiguous(),
            "b": torch.zeros((cout,), dtype=torch.float32,
                             device=key.device)}


def _apply_conv(p: dict[str, torch.Tensor], x: torch.Tensor, stride: int
                ) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride=stride)


class ActorCritic:
    """Discrete or continuous actor-critic over an EnvSpec."""

    def __init__(self, spec: EnvSpec,
                 hidden: tuple[int, ...] = (256, 128, 64)):
        self.spec = spec
        self.hidden = tuple(hidden)
        self.pixel = len(spec.obs_spec.shape) == 3
        self.discrete = not spec.act_spec.dtype.is_floating_point
        if self.discrete:
            self.act_dim = spec.num_actions
        else:
            self.act_dim = int(spec.act_spec.shape[0])

    def init(self, key: torch.Tensor) -> dict[str, Any]:
        """Parameters on ``key``'s device."""
        ks = random.split(key, 10)
        p: dict[str, Any] = {}
        if self.pixel:
            p["conv1"] = _conv(ks[0], self.spec.obs_spec.shape[0], 32, 8, 8)
            p["conv2"] = _conv(ks[1], 32, 64, 4, 4)
            p["conv3"] = _conv(ks[2], 64, 64, 3, 3)
            p["fc"] = _dense(ks[3], 64 * 7 * 7, 512)
            feat = 512
        else:
            feat = int(self.spec.obs_spec.shape[0])
            for i, h in enumerate(self.hidden):
                p[f"mlp{i}"] = _dense(ks[i], feat, h)
                feat = h
        p["pi"] = _dense(ks[7], feat, self.act_dim, scale=0.01)
        p["v"] = _dense(ks[8], feat, 1, scale=1.0)
        if not self.discrete:
            p["log_std"] = torch.zeros((self.act_dim,), dtype=torch.float32,
                                       device=key.device)
        return p

    def trunk(self, p: dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
        if self.pixel:
            x = obs.to(torch.float32) / 255.0      # NCHW, as served
            x = F.relu(_apply_conv(p["conv1"], x, 4))
            x = F.relu(_apply_conv(p["conv2"], x, 2))
            x = F.relu(_apply_conv(p["conv3"], x, 1))
            # flatten in NHWC order, the rows of the JAX package's fc.w
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return F.relu(_apply_dense(p["fc"], x))
        x = obs.to(torch.float32)
        for i in range(len(self.hidden)):
            x = F.elu(_apply_dense(p[f"mlp{i}"], x))
        return x

    def forward(self, p: dict[str, Any], obs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits_or_mean, value)."""
        feat = self.trunk(p, obs)
        return _apply_dense(p["pi"], feat), _apply_dense(p["v"], feat)[..., 0]

    def _gaussian(self, p, mean, actions):
        """(logp, entropy) of ``actions`` under N(mean, exp(log_std))."""
        log_std = p["log_std"]
        std = torch.exp(log_std)
        logp = -0.5 * torch.sum(
            ((actions - mean) / std) ** 2 + 2 * log_std + LOG_2PI, -1)
        ent = torch.sum(log_std + 0.5 * LOG_2PI_E) * torch.ones(
            actions.shape[0], device=mean.device)
        return logp, ent

    # ---------------- distribution ops ----------------------------- #
    def sample(self, p, obs, key, rows=None):
        """Returns (action, logp, value, entropy).  Discrete actions are
        ``random.categorical`` draws (Gumbel-max), continuous ones the
        mean plus ``random.normal`` noise.  ``rows``: ``(first, M)`` when
        ``obs`` are rows ``first:first + len(obs)`` of a block of M (a
        process's part of a sharded pool's block): the noise is drawn
        for all M and these rows taken, so each row's draw is the one
        the whole block would get."""
        pi, v = self.forward(p, obs)

        def noise(draw):
            if rows is None:
                return draw(key, tuple(pi.shape))
            lo, total = rows
            return draw(key, (total,) + tuple(pi.shape[1:]))[
                lo:lo + pi.shape[0]]

        if self.discrete:
            a = (random.categorical(key, pi) if rows is None
                 else torch.argmax(noise(random.gumbel) + pi, dim=-1))
            ls = F.log_softmax(pi, -1)
            logp = ls.gather(1, a[:, None])[:, 0]
            ent = -torch.sum(F.softmax(pi, -1) * ls, -1)
            return a.to(self.spec.act_spec.dtype), logp, v, ent
        std = torch.exp(p["log_std"])
        a = pi + std * noise(random.normal)
        logp, ent = self._gaussian(p, pi, a)
        return a, logp, v, ent

    def logp_entropy(self, p, obs, actions):
        """Returns (logp, entropy, value) of ``actions``."""
        pi, v = self.forward(p, obs)
        if self.discrete:
            ls = F.log_softmax(pi, -1)
            logp = ls.gather(1, actions.long()[:, None])[:, 0]
            ent = -torch.sum(F.softmax(pi, -1) * ls, -1)
            return logp, ent, v
        logp, ent = self._gaussian(p, pi, actions)
        return logp, ent, v


def params_from_jax(params_np: dict[str, Any],
                    device: torch.device | str | None = None
                    ) -> dict[str, Any]:
    """The port's parameters from the numpy leaves of a ``repro``
    ``ActorCritic.init`` dict (``jax.tree.map(np.asarray, params)``):
    the same keys and values, conv weights moved from HWIO to OIHW.
    ``fc.w`` keeps its rows: the trunk flattens in NHWC order."""
    device = resolve_device(device)

    def load(name: str, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: load(f"{name}.{k}", v) for k, v in x.items()}
        arr = np.asarray(x, dtype=np.float32)
        if name.startswith(".conv") and name.endswith(".w"):
            arr = arr.transpose(3, 2, 0, 1)
        return torch.tensor(np.ascontiguousarray(arr), device=device)

    return load("", params_np)


__all__ = ["ActorCritic", "params_from_jax"]
