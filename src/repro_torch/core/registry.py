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
    pool = make("Ant-v3", num_envs=64, batch_size=32,
                engine="thread", device="cpu")           # host thread pool
    pool = make("Ant-v3", num_envs=64, engine="subprocess",
                num_threads=4)                           # gym.vector baseline
    pool = make("Ant-v3", num_envs=4096, batch_size=2048,
                engine="device-sharded", num_shards=4,
                schedule="hierarchical")                 # D shards
    env = make_py("Ant-v3", seed=0)                      # one numpy env

  engine            pool class              execution substrate
  ----------------  ----------------------  ---------------------------------
  device (default)  DeviceEnvPool           N lanes on one device (the
                                            mesh engine at D = 1)
  device-masked     DeviceEnvPool(masked)   tick ablation, one device
  device-sharded    MeshEnvPool             D shards, on one device or
                                            over torch.distributed ranks
  thread            ThreadEnvPool           host threads (paper's C++ pool)
  forloop           ForLoopEnv              sequential baseline (Table 1)
  subprocess        SubprocessEnv           gym.vector-style workers

Every engine derives its per-env init keys the same way
(``derive_env_keys(PRNGKey(seed), N)``), so with the same actions routed
by ``env_id`` all of them emit the same streams.  The host engines step
each env as one lane of its batched env on ``device`` (the card unless
``device="cpu"``) and return their blocks as tensors there.  The
sharded engine takes ``num_shards`` shards on ``device``, or ``mesh``
(``core/engine.py::make_env_mesh``, which may span the processes of a
``torch.distributed`` job); without either, one shard a process.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.baselines import ForLoopEnv, SubprocessEnv
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import DeviceEnvPool, derive_env_keys
from repro_torch.core.host_pool import ThreadEnvPool, TorchHostEnv
from repro_torch.core.sharded_pool import ShardedDeviceEnvPool
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
from repro_torch.envs.host_numpy import (
    PyAtariLike,
    PyCartPole,
    PyMujocoLike,
    PyPendulum,
)
from repro_torch.envs.mujoco_like import MujocoLike
from repro_torch.envs.token_env import TokenEnv

ENGINES = ("device", "device-masked", "device-sharded", "thread", "forloop",
           "subprocess")
HOST_ENGINES = ("thread", "forloop", "subprocess")

# task -> factory of one pure-numpy env (``make_py``)
_PY_REGISTRY: dict[str, Callable[..., Any]] = {
    "CartPole-v1": PyCartPole,
    "Pendulum-v1": PyPendulum,
    "Pong-v5": PyAtariLike,
    "Ant-v3": PyMujocoLike,
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


# tasks added by ``register``: task -> (env factory, default pipeline)
_REGISTERED: dict[str, tuple[Callable[..., Environment],
                             tuple[Transform, ...]]] = {}


def _registry() -> dict[str, tuple[Callable[..., Environment],
                                   tuple[Transform, ...]]]:
    """task -> (env factory, default transform pipeline): the built-in
    tasks, then those added by ``register``."""
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
        **_REGISTERED,
    }


def register(name: str, factory: Callable[..., Environment],
             transforms: tuple[Transform, ...] = ()) -> None:
    """Register a device task; ``transforms`` is its default in-engine
    pipeline (e.g. ``Pong-v5`` ships ``FrameStack(4)``).  A name taken
    by a built-in task is overridden."""
    _REGISTERED[name] = (factory, tuple(transforms))


def default_transforms(task_id: str) -> tuple[Transform, ...]:
    """The task's registered default transform pipeline."""
    return _registry().get(task_id, (None, ()))[1]


def list_envs() -> list[str]:
    return sorted(_registry())


def list_engines() -> tuple[str, ...]:
    return ENGINES


def register_py(name: str, factory: Callable[..., Any]) -> None:
    """Register a pure-Python env factory for ``make_py``."""
    _PY_REGISTRY[name] = factory


def make_py(task_id: str, seed: int = 0, **kwargs: Any):
    """One pure-Python env (the paper's Table 2 "Python" baseline)."""
    if task_id not in _PY_REGISTRY:
        raise KeyError(
            f"no python env {task_id!r}; known: {sorted(_PY_REGISTRY)}")
    return _PY_REGISTRY[task_id](seed=seed, **kwargs)


class _SpawnFactory:
    """Picklable env factory of the host engines: env ``i`` of ``task_id``
    as a ``TorchHostEnv`` on ``device``, reset first from
    ``init_keys[i]``.  Subprocess workers unpickle it after ``spawn``,
    each opening its own CUDA context on the card."""

    def __init__(self, task_id: str, env_kwargs: dict[str, Any],
                 init_keys: np.ndarray, device: str,
                 batched: bool | None):
        self.task_id = task_id
        self.env_kwargs = env_kwargs
        self.init_keys = init_keys
        self.device = device
        self.batched = batched

    def env(self) -> Environment:
        return _registry()[self.task_id][0](**self.env_kwargs)

    def __call__(self, i: int) -> TorchHostEnv:
        return TorchHostEnv(self.env(), self.init_keys[i],
                            device=self.device, batched=self.batched)


def _make_host(engine: str, task_id: str, num_envs: int,
               batch_size: int | None, num_threads: int | None, seed: int,
               batched: bool | None, schedule: str, cost_ema_alpha: float,
               transforms: tuple[Transform, ...], obs: bool,
               device: torch.device, env_kwargs: dict[str, Any]):
    if engine != "thread" and schedule != "fifo":
        raise ValueError(
            f"engine {engine!r} is synchronous (M == N): no selection "
            f"freedom, schedule must stay 'fifo' (got {schedule!r})")
    keys, _ = derive_env_keys(random.PRNGKey(seed), num_envs)
    factory = _SpawnFactory(task_id, env_kwargs, keys.numpy(),
                            str(device), batched)
    if engine == "subprocess":
        if device.type == "cuda":
            # build the kernels once here, so no spawned worker runs nvcc
            from repro_torch.kernels.build import library

            library()
        return SubprocessEnv(factory, num_envs, num_workers=num_threads,
                             spec=factory.env().spec, transforms=transforms,
                             obs=obs, device=device)
    fns = [functools.partial(factory, i) for i in range(num_envs)]
    if engine == "forloop":
        return ForLoopEnv(fns, transforms=transforms, obs=obs, device=device)
    return ThreadEnvPool(fns, batch_size=batch_size, num_threads=num_threads,
                         schedule=schedule, cost_ema_alpha=cost_ema_alpha,
                         transforms=transforms, obs=obs, device=device)


def make(task_id: str, num_envs: int, batch_size: int | None = None,
         engine: str = "device", num_threads: int | None = None,
         num_shards: int | None = None, mesh: Any = None, seed: int = 0,
         batched: bool | None = None, schedule: str = "fifo",
         sched_patience: float = 1.0, cost_ema_alpha: float = 1.0,
         transforms: Any = None, obs: bool = True,
         device: torch.device | str | None = None,
         **env_kwargs: Any):
    """Create an env pool on ``device`` (default ``cuda``, which must be
    present: there is no quiet fallback to the CPU).

    The keywords are ``repro.make``'s, by the same names and defaults,
    and the added ``device``.  ``engine="device"``: ``batch_size`` None
    or ``num_envs`` is sync mode, smaller is async under ``schedule``
    (``fifo`` or ``sjf``); ``engine="device-masked"`` is the tick
    ablation.  ``engine="thread"`` is the host thread pool over
    ``num_threads`` workers (default: one a core, at most N), async
    when ``batch_size < num_envs``, with ``schedule`` through its numpy
    mirror and ``cost_ema_alpha`` its cost estimator; ``forloop`` and
    ``subprocess`` (``num_threads`` worker processes) are synchronous.
    The device engines ignore ``num_threads``; ``seed`` derives the host
    engines' per-env init keys (the device engine takes its key at
    ``reset``).  ``obs`` (default True) keeps the engine's counters for
    ``pool.stats()``; False leaves them out.  ``batched`` None (or True)
    takes the env's native batched view, False the generic adapter.
    ``transforms=None`` takes the task's registered pipeline, an
    explicit list replaces it.  ``engine="device-sharded"`` is the mesh
    engine over ``mesh`` (an ``EnvMesh``, whose device it takes) or
    ``num_shards`` shards on ``device``, by default one shard a process
    (``ShardedDeviceEnvPool``); it also takes ``schedule="hierarchical"``
    with its fairness knob ``sched_patience``.  The other engines ignore
    ``num_shards`` and ``mesh``, as ``repro.make`` does."""
    tasks = _registry()
    if task_id not in tasks:
        raise KeyError(f"unknown env {task_id!r}; known: {sorted(tasks)}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    factory, default = tasks[task_id]
    tfs = resolve_transforms(transforms, default)
    if engine == "device-sharded":
        return ShardedDeviceEnvPool(
            factory(**env_kwargs), num_envs, batch_size,
            mesh=mesh if mesh is not None else num_shards, batched=batched,
            schedule=schedule, sched_patience=sched_patience,
            transforms=tfs, obs=obs, device=device)
    dev = resolve_device(device)
    if engine in HOST_ENGINES:
        return _make_host(engine, task_id, num_envs, batch_size, num_threads,
                          seed, batched, schedule, cost_ema_alpha, tfs, obs,
                          dev, env_kwargs)
    if schedule == "hierarchical":
        # the cross-shard policy needs a mesh; the one-device engine
        # refuses it, as the JAX package's does
        raise ValueError(
            "schedule='hierarchical' is the cross-shard policy: it needs a "
            "device mesh (use engine='device-sharded')")
    return DeviceEnvPool(factory(**env_kwargs), num_envs, batch_size,
                         mode="masked" if engine == "device-masked" else None,
                         batched=batched, schedule=schedule,
                         sched_patience=sched_patience, transforms=tfs,
                         obs=obs, device=dev)


__all__ = ["ENGINES", "default_transforms", "list_engines", "list_envs",
           "make", "make_py", "register", "register_py", "resolve_device"]
