"""``repro_torch.make`` — the ``envpool.make`` analogue
(``repro/core/registry.py``).

    pool = make("Ant-v3", num_envs=4096)                        # sync
    pool = make("Ant-v3", num_envs=4096, batch_size=2048)       # async
    pool = make("PongClassic-v5", num_envs=1024, batch_size=512,
                schedule="sjf")
    pool = make("TokenRagged-v0", num_envs=256, batch_size=128,
                vocab=151936)                            # env_kwargs

    pool = make("Ant-v3", num_envs=4096, batch_size=2048,
                engine="device-masked")                  # tick ablation

The device engine is ported, with its masked (tick) mode and its
telemetry (``obs=True``, ``pool.stats()``); the host and sharded engines
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.engine import DeviceEnvPool
from repro_torch.core.transforms import (
    FrameStack,
    Grayscale,
    NormalizeObs,
    Resize,
    RewardClip,
    Transform,
    resolve_transforms,
)
from repro_torch.envs.atari_like import AtariLike
from repro_torch.envs.base import Environment
from repro_torch.envs.classic import CartPole, MountainCar, Pendulum
from repro_torch.envs.mujoco_like import MujocoLike
from repro_torch.envs.token_env import TokenEnv

# engine -> the ROADMAP item that ports it
_LATER_ENGINES = {
    "device-sharded": "A12",
    "thread": "A9", "forloop": "A9", "subprocess": "A9",
}


def _pong_classic(**kw: Any) -> AtariLike:
    return AtariLike(**{"obs_mode": "rgb", **kw})


def _token_skew(**kw: Any) -> TokenEnv:
    # long-tail step cost: a quarter of episodes cost 8x per step
    return TokenEnv(**{"heavy_frac": 0.25, "heavy_scale": 8, **kw})


def _token_ragged(**kw: Any) -> TokenEnv:
    # ragged generation lengths: 75% of episodes end at ep_len / 4
    return TokenEnv(**{"short_frac": 0.75, "len_scale": 4, **kw})


def _ant_skew(**kw: Any) -> MujocoLike:
    # long-tail solver cost: a quarter of episodes run 4x the iterations
    return MujocoLike(**{"heavy_frac": 0.25, "heavy_iters": 4, **kw})


def _registry() -> dict[str, tuple[Callable[..., Environment],
                                   tuple[Transform, ...]]]:
    """task -> (env factory, default transform pipeline)."""
    return {
        "CartPole-v1": (CartPole, ()),
        "MountainCar-v0": (MountainCar, ()),
        "Pendulum-v1": (Pendulum, ()),
        "AntNorm-v3": (MujocoLike, (NormalizeObs(),)),
        "AntSkew-v3": (_ant_skew, ()),
        "Ant-v3": (MujocoLike, ()),
        "MujocoLike-Ant-v3": (MujocoLike, ()),
        "Pong-v5": (AtariLike, (FrameStack(4),)),
        "AtariLike-Pong-v5": (AtariLike, (FrameStack(4),)),
        "PongStack-v5": (AtariLike, (FrameStack(4), RewardClip())),
        # the classic ALE pipeline, in-engine: native RGB render ->
        # grayscale -> 84x84 area resize -> stack -> clip
        "PongClassic-v5": (_pong_classic, (Grayscale(), Resize(84, 84),
                                           FrameStack(4), RewardClip())),
        "TokenCopy-v0": (TokenEnv, ()),
        "TokenSkew-v0": (_token_skew, ()),
        "TokenRagged-v0": (_token_ragged, ()),
    }


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device``, or ``cuda`` when it is None and a card is present;
    there is no quiet fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def list_envs() -> list[str]:
    return sorted(_registry())


def make(task_id: str, num_envs: int, batch_size: int | None = None,
         engine: str = "device", num_threads: int | None = None,
         num_shards: int | None = None, mesh: Any = None, seed: int = 0,
         batched: bool | None = None, schedule: str = "fifo",
         sched_patience: float = 1.0, cost_ema_alpha: float = 1.0,
         transforms: Any = None, obs: bool = True,
         device: torch.device | str | None = None,
         **env_kwargs: Any) -> DeviceEnvPool:
    """Create a device env pool on ``device`` (default ``cuda``, which
    must be present: there is no quiet fallback to the CPU).

    The keywords are ``repro.make``'s, by the same names and defaults,
    and the added ``device``.  ``engine="device"``: ``batch_size`` None
    or ``num_envs`` is sync mode, smaller is async under ``schedule``
    (``fifo`` or ``sjf``); ``engine="device-masked"`` is the tick
    ablation.  ``obs`` (default True) keeps the engine's counters for
    ``pool.stats()``; False leaves them out.
    ``batched`` None (or True) takes the env's native batched view,
    False the generic adapter.  ``transforms=None`` takes the task's
    registered pipeline, an explicit list replaces it.  ``seed`` seeds
    the host engines of the JAX package and ``cost_ema_alpha`` their
    cost estimator, ``sched_patience`` the hierarchical schedule; the
    device engine under fifo or sjf uses none of them.  ``num_threads``
    (host engines, A9), ``num_shards`` and ``mesh`` (the sharded
    engine, A12) are not ported yet and raise when given."""
    tasks = _registry()
    if task_id not in tasks:
        raise KeyError(f"unknown env {task_id!r}; known: {sorted(tasks)}")
    if engine in _LATER_ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP "
            f"{_LATER_ENGINES[engine]})")
    if engine not in ("device", "device-masked"):
        raise ValueError(f"unknown engine {engine!r}")
    for name, value, item in (("num_threads", num_threads, "A9"),
                              ("num_shards", num_shards, "A12"),
                              ("mesh", mesh, "A12")):
        if value is not None:
            raise NotImplementedError(
                f"{name}={value!r}: its engine is not ported yet (ROADMAP "
                f"{item})")
    factory, default = tasks[task_id]
    return DeviceEnvPool(factory(**env_kwargs), num_envs, batch_size,
                         mode="masked" if engine == "device-masked" else None,
                         batched=batched, schedule=schedule,
                         transforms=resolve_transforms(transforms, default),
                         obs=obs, device=resolve_device(device))


__all__ = ["list_envs", "make", "resolve_device"]
