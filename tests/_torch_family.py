"""Helpers of the xLSTM, Whisper and vlm parity tests: both packages'
smoke configs in f32, ``repro``'s weights carried into the port, and
leaf-by-leaf comparisons of parameter and gradient trees (dicts and
lists, ``repro``'s pytrees keyed as the port's ``tree_leaves_with_path``
keys them)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import build_model as j_build

from repro_torch.configs import get_smoke_config
from repro_torch.rl import policy_lm as tlm
from repro_torch.utils.tree import tree_leaves_with_path

TOL = 2e-4


def configs(name: str, **variant):
    """(repro config, port config) of ``name``'s smoke size, f32 compute,
    ``repro`` with static per-layer windows, ``variant`` applied."""
    jcfg = j_smoke(name).replace(compute_dtype=jnp.float32,
                                 scan_layers=False, **variant)
    tcfg = get_smoke_config(name).replace(compute_dtype=torch.float32,
                                          **variant)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed: int = 0):
    """``repro``'s ``Model.init`` weights (a decoder's layers stacked)
    and the port's copy through ``params_from_jax``."""
    jparams = j_build(jcfg.replace(scan_layers=True)).init(
        jax.random.PRNGKey(seed))
    return jparams, tlm.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        tcfg, "cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol: float = TOL, msg: str = "") -> None:
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol,
                               err_msg=msg)


def leaves(tree) -> dict:
    """Path -> float64 numpy leaf, for a port tree or a ``repro``
    pytree, the paths joined with dots (``layers.0.mlstm.wq``)."""
    if any(isinstance(x, torch.Tensor) for _, x in
           tree_leaves_with_path(tree)):
        return {p: np.asarray(f32(v), np.float64)
                for p, v in tree_leaves_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(f32(v), np.float64)
            for path, v in flat}


def assert_leaves_close(got: dict, want: dict, tol: float) -> None:
    """Each leaf within ``tol`` times the largest entry of ``want``'s."""
    assert set(got) == set(want)
    for name in want:
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, (name, err)


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
