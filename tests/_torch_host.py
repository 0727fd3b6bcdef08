"""Rollouts of host engines (either package's) and of the port's device
engine, for the host-engine parity tests: the same seed, the same
actions (``_torch_pair.actions``, routed by ``env_id``), every block
sorted by ``env_id`` (a thread pool serves its first finishers) and
compared field by field.
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch
from _torch_pair import EXACT, actions

FIELDS = ("obs", "reward", "done", "terminated", "truncated", "env_id",
          "episode_return", "episode_length", "step_cost")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def by_id(block) -> dict[str, np.ndarray]:
    """A recv dict or TimeStep as numpy fields, rows in ``env_id``
    order."""
    get = block.get if isinstance(block, dict) else (
        lambda k: getattr(block, k))
    out = {k: to_np(get(k)) for k in FIELDS}
    order = np.argsort(out["env_id"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def host_rollout(pool, spec, steps: int, tensors: bool = False) -> list:
    """A host pool reset, then ``steps`` steps; every block ``by_id``.
    ``tensors``: actions and ids go to ``step`` as torch tensors."""
    out = pool.reset()
    blocks = [by_id(out)]
    for t in range(steps):
        ids = to_np(out["env_id"])
        a = actions(spec, ids, t)
        if tensors:
            a, ids = torch.from_numpy(a), out["env_id"]
        out = pool.step(a, ids)
        blocks.append(by_id(out))
    return blocks


def device_rollout(pool, steps: int, seed: int = 0) -> tuple[list, dict]:
    """The same rollout on a device engine from ``PRNGKey(seed)``;
    returns the blocks and ``stats()``."""
    ps, ts = pool.reset(repro_torch.random.PRNGKey(seed))
    blocks = [by_id(ts)]
    for t in range(steps):
        a = actions(pool.spec, to_np(ts.env_id), t)
        ps, ts = pool.step(ps, torch.from_numpy(a), ts.env_id)
        blocks.append(by_id(ts))
    return blocks, pool.stats(ps)


def reset_cost_as_device(blocks: list) -> list:
    """Host blocks with the reset block's ``step_cost`` as the device
    engine serves it.  The host engines of both packages fill a reset
    slot's ``step_cost`` with 1 and the device engines with 0; no
    counter reads it (a reset is not a step)."""
    assert (blocks[0]["step_cost"] == 1).all()
    return [dict(blocks[0], step_cost=np.zeros_like(
        blocks[0]["step_cost"]))] + blocks[1:]


def compare_blocks(tag: str, got: list, want: list, atol: float = 0.0,
                   obs_atol: float | None = None) -> None:
    """Discrete fields bitwise; obs, reward and episode_return bitwise
    where the tolerance is 0, else within it (``obs_atol`` defaults to
    ``atol``)."""
    assert len(got) == len(want), tag
    obs_atol = atol if obs_atol is None else obs_atol
    for t, (g, w) in enumerate(zip(got, want)):
        for k in EXACT:
            np.testing.assert_array_equal(g[k], w[k],
                                          err_msg=f"{tag} block {t} {k}")
        for k, tol in (("obs", obs_atol), ("reward", atol),
                       ("episode_return", atol)):
            assert g[k].dtype == w[k].dtype, (tag, t, k)
            if tol:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                           err_msg=f"{tag} block {t} {k}")
            else:
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{tag} block {t} {k}")
