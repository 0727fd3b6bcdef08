"""Picklable raising-env factory for the port's SubprocessEnv
worker-exception test (spawned workers re-import this module by name,
so it lives at module scope, not inside a test)."""

import numpy as np

from repro_torch.core.host_pool import HostEnv


class RaisingEnv(HostEnv):
    """Resets fine; every step raises."""

    def __init__(self):
        from repro_torch.envs.classic import CartPole

        self.spec = CartPole().spec

    def reset(self) -> np.ndarray:
        return np.zeros(self.spec.obs_spec.shape, np.float32)

    def step(self, action):
        raise ValueError("boom in worker")


class RaisingFactory:
    def __call__(self, i: int) -> RaisingEnv:
        return RaisingEnv()
