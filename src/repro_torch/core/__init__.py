"""The engine package: ``repro.core``'s import surface, as far as it is
ported.

Names resolve on first use (PEP 562), so importing a submodule of
``repro_torch.core`` does not import every engine.
"""

import importlib

# name -> the submodule of repro_torch.core that defines it
_EXPORTS = {
    "ArraySpec": "specs", "EnvSpec": "specs", "TimeStep": "specs",
    "DeviceEnvPool": "engine", "PoolState": "engine", "make_pool": "engine",
    "MeshEnvPool": "engine", "make_env_mesh": "engine",
    "ShardedDeviceEnvPool": "sharded_pool",
    "BoundEnvPool": "protocol", "EnvPool": "protocol",
    "FunctionalEnvPool": "protocol", "bind": "protocol",
    "is_functional": "protocol", "to_timestep": "protocol",
    "list_engines": "registry", "list_envs": "registry", "make": "registry",
    "make_py": "registry", "register": "registry",
    "register_py": "registry",
    "Crop": "transforms", "EpisodicLife": "transforms",
    "FrameStack": "transforms", "Grayscale": "transforms",
    "NormalizeObs": "transforms", "ObsCast": "transforms",
    "Resize": "transforms", "RewardClip": "transforms",
    "Transform": "transforms", "TransformPipeline": "transforms",
    "DmEnv": "dm_api",
    "build_collect_fn": "xla_loop", "build_random_collect_fn": "xla_loop",
    "collect_init": "xla_loop",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        module = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
