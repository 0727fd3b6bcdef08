"""repro_torch: the EnvPool reproduction on PyTorch and CUDA (Hopper).

The port of the JAX package ``repro``; it imports neither JAX nor any
module of ``repro``.  Importing it builds no kernel: the CUDA library is
compiled on the first launch (``kernels/build.py``).

    import repro_torch
    pool = repro_torch.make("PongClassic-v5", num_envs=1024)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    ps, ts = pool.step(ps, actions, ts.env_id)

    pool = repro_torch.make("Ant-v3", num_envs=64, engine="thread",
                            device="cpu")        # the host thread pool
    out = pool.reset()                           # a dict of tensors
    out = pool.step(actions, out["env_id"])
"""

from repro_torch import random
from repro_torch.core.registry import (
    list_engines,
    list_envs,
    make,
    make_py,
    register_py,
)
from repro_torch.core.transforms import (
    Crop,
    EpisodicLife,
    FrameStack,
    Grayscale,
    NormalizeObs,
    ObsCast,
    Resize,
    RewardClip,
    Transform,
)

__version__ = "0.1.0"

# the rest of ``repro``'s ``_CORE_EXPORTS``, resolved from
# ``repro_torch.core`` on first use
_CORE_EXPORTS = (
    "DmEnv", "EnvPool", "FunctionalEnvPool", "bind", "is_functional",
    "to_timestep", "build_collect_fn", "build_random_collect_fn",
    "collect_init", "TransformPipeline",
)


def __getattr__(name: str):
    if name in _CORE_EXPORTS:
        from repro_torch import core

        return getattr(core, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


__all__ = [
    "Crop", "EpisodicLife", "FrameStack", "Grayscale", "NormalizeObs",
    "ObsCast", "Resize", "RewardClip", "Transform", "list_engines",
    "list_envs", "make", "make_py", "random", "register_py",
    *_CORE_EXPORTS,
]
