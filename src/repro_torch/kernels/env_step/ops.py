"""Public wrapper of the batched physics kernel (``csrc/env_step.cu``).

``env_multi_step`` launches the CUDA kernel for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors; ``backend="reference"``
forces the plain version on the card for comparisons.
``env_multi_step.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import (
    check_launch,
    count_launch,
    launch,
    resolve_backend,
)
from repro_torch.kernels.env_step.ref import (
    N_JOINTS,
    STATE_DIM,
    env_multi_substep_reference,
)


# csrc/env_step.cu's kGroup and kThreads: a lane's threads (thread j
# owns joint j) and a block's
ENV_GROUP = 8
ENV_THREADS = 128


def env_step_plan(n: int) -> int:
    """Blocks of the physics launch: lane ``l`` on threads
    ``[l * ENV_GROUP, (l + 1) * ENV_GROUP)`` of the grid, the fewest
    blocks of ``ENV_THREADS`` that cover all ``n`` lanes."""
    return -(-n * ENV_GROUP // ENV_THREADS)


def _check(name: str, x: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> None:
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def env_multi_step(
    state: torch.Tensor,                  # (N, 28) f32
    action: torch.Tensor,                 # (N, 8) f32
    cost: torch.Tensor | None = None,     # (N,) int32
    reward0: torch.Tensor | None = None,  # (N,) f32
    *,
    n_sub: int,
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane ``n`` runs ``min(cost[n], n_sub)`` physics substeps (all
    ``n_sub`` when ``cost`` is None) in one pass over the state block;
    returns ``(new_state, reward accumulated on top of reward0)``."""
    n = state.shape[0]
    if resolve_backend(backend, state) != "cuda":
        if cost is None:
            cost = torch.full((n,), n_sub, dtype=torch.int32,
                              device=state.device)
        return env_multi_substep_reference(
            state, action, torch.clamp_max(cost, n_sub), reward0)

    dev = state.device
    _check("state", state, (n, STATE_DIM), torch.float32, dev)
    _check("action", action, (n, N_JOINTS), torch.float32, dev)
    if cost is not None:
        _check("cost", cost, (n,), torch.int32, dev)
    if reward0 is not None:
        _check("reward0", reward0, (n,), torch.float32, dev)
    from repro_torch.kernels.build import library

    out = torch.empty_like(state)
    reward = torch.empty((n,), dtype=torch.float32, device=dev)
    err = launch(
        state, library().env_step_launch,
        state.data_ptr(), action.data_ptr(),
        None if cost is None else cost.data_ptr(),
        None if reward0 is None else reward0.data_ptr(),
        out.data_ptr(), reward.data_ptr(), n, int(n_sub),
        env_step_plan(n),
    )
    check_launch("env_step", err)
    count_launch(env_multi_step)
    return out, reward


env_multi_step.launches = 0

__all__ = ["env_multi_step", "env_step_plan"]
