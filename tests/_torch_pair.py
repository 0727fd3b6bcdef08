"""Side-by-side rollouts of a ``repro`` pool and a ``repro_torch`` pool
on the CPU, for the port's parity tests: the same seed, the same
actions (numpy, drawn per step and routed by ``env_id``), every served
block compared.

Discrete fields (ids, done, terminated, truncated, step_cost,
episode_length) are held bitwise; obs, reward and episode_return
bitwise where ``atol`` is 0, else within it.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.core.registry as jax_registry
import repro_torch

EXACT = ("env_id", "done", "terminated", "truncated", "step_cost",
         "episode_length")
FLOAT = ("obs", "reward", "episode_return")


def make_pair(task, n, m=None, jax_kw=None, torch_kw=None, **kw):
    """``(repro pool, port pool)`` of ``task``; ``kw`` go to both,
    ``jax_kw``/``torch_kw`` to one (e.g. each package's transforms)."""
    jp = jax_registry.make(task, num_envs=n, batch_size=m,
                           **{**kw, **(jax_kw or {})})
    tp = repro_torch.make(task, num_envs=n, batch_size=m, device="cpu",
                          **{**kw, **(torch_kw or {})})
    return jp, tp


def actions(spec, ids, t):
    """Step ``t``'s actions for the lanes ``ids``, from a table over
    every lane drawn with seed ``t``."""
    act = spec.act_spec
    rng = np.random.default_rng(1000 + t)
    shape = (64,) + tuple(act.shape)
    if act.dtype.is_floating_point:
        table = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
    else:
        table = rng.integers(0, int(act.maximum) + 1, shape).astype(np.int32)
    return table[np.asarray(ids)]


def compare(tag, jts, tts, atol=0.0, rtol=0.0):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tts, f).numpy(),
                                      np.asarray(getattr(jts, f)),
                                      err_msg=f"{tag} {f}")
    for f in FLOAT:
        got, want = getattr(tts, f).numpy(), np.asarray(getattr(jts, f))
        assert got.dtype == want.dtype, (tag, f, got.dtype, want.dtype)
        if atol or rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{tag} {f}")


def rollout(jp, tp, steps, seed=0, atol=0.0, rtol=0.0, on_block=None):
    """Reset both pools from ``seed`` and step them ``steps`` times,
    comparing every block; returns the final ``(repro PoolState, port
    PoolState)``.  ``on_block(t, jts, tts)`` sees each block."""
    jps, jts = jp.reset(jax.random.PRNGKey(seed))
    tps, tts = tp.reset(repro_torch.random.PRNGKey(seed))
    jstep = jax.jit(jp.step)
    for t in range(steps + 1):
        compare(f"{tp.spec.name} block {t}", jts, tts, atol, rtol)
        if on_block is not None:
            on_block(t, jts, tts)
        if t == steps:
            break
        a = actions(tp.spec, jts.env_id, t)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts.env_id)
    return jps, tps


def assert_stats_equal(js, ts, tag=""):
    """Two ``stats()`` dicts, bitwise: the same keys and values."""
    assert set(js) == set(ts), (tag, set(js) ^ set(ts))
    for k, v in js.items():
        if isinstance(v, np.ndarray):
            assert ts[k].dtype == v.dtype, (tag, k)
            np.testing.assert_array_equal(ts[k], v, err_msg=f"{tag} {k}")
        else:
            assert type(ts[k]) is type(v) and ts[k] == v, (tag, k, ts[k], v)


def jax_leaves(ps) -> dict:
    """The leaves of a ``repro`` PoolState keyed by the port's paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ps)[0]:
        parts = [str(getattr(k, "name", getattr(k, "idx",
                                                getattr(k, "key", k))))
                 for k in path]
        out[".".join(parts)] = np.asarray(leaf)
    return out
