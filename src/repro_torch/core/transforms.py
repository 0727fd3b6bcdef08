"""In-engine transform pipeline (``repro/core/transforms.py``): the
preprocessing applied to every served block inside recv.

A ``Transform`` has a spec transformer (``transform_spec``, so
``pool.spec`` stays truthful), fresh state (``init``) and ``apply`` over
one served block of M rows.  ``per_lane`` transforms keep state rows
with a leading N dim that the engine gathers for the served lanes and
scatters back.  ``on_reset`` semantics ride on auto-reset: a served step
with ``done`` already carries the next episode's first obs, so stateful
transforms re-initialize that lane from it; a per-lane ``fresh`` latch
covers the pool's first serve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.specs import EnvSpec, TimeStep
from repro_torch.kernels.image.ref import RESIZE_METHODS, check_crop
from repro_torch.utils.tree import (
    lane_mask,
    tree_gather,
    tree_leaves,
    tree_scatter,
)


class Transform:
    """One preprocessing stage."""

    name = "identity"
    # True: state leaves carry a leading num_envs dim, gathered and
    # scattered by the engine for each served block
    per_lane = False

    def transform_spec(self, spec: EnvSpec) -> EnvSpec:
        return spec

    def init(self, spec: EnvSpec, num_envs: int,
             device: torch.device) -> Any:
        return ()

    def apply(self, state: Any, ts: TimeStep, spec: EnvSpec
              ) -> tuple[Any, TimeStep]:
        """Transform one served block; ``spec`` is this stage's input.
        A transform with global (not per-lane) state also takes
        ``mesh=``: the pool's ``EnvMesh`` when it has more than one
        shard, its state then one copy a shard the process holds."""
        return state, ts


class FrameStack(Transform):
    """Stack the last ``k`` served observations per lane, oldest first.
    On auto-reset and on a lane's first serve the stack is refilled with
    the episode's first observation."""

    name = "frame_stack"
    per_lane = True

    def __init__(self, k: int = 4):
        if k < 1:
            raise ValueError(f"FrameStack needs k >= 1, got {k}")
        self.k = int(k)

    def transform_spec(self, spec):
        o = spec.obs_spec
        return dataclasses.replace(
            spec, obs_spec=dataclasses.replace(o, shape=(self.k,) + o.shape))

    def init(self, spec, num_envs, device):
        o = spec.obs_spec
        return {
            "buf": torch.zeros((num_envs, self.k) + o.shape, dtype=o.dtype,
                               device=device),
            "fresh": torch.ones((num_envs,), dtype=torch.bool,
                                device=device),
        }

    def apply(self, state, ts, spec):
        obs = ts.obs
        pushed = torch.cat([state["buf"][:, 1:], obs[:, None]], dim=1)
        reset = state["fresh"] | ts.done
        buf = torch.where(lane_mask(reset, pushed),
                          obs[:, None].expand_as(pushed), pushed)
        return ({"buf": buf, "fresh": torch.zeros_like(state["fresh"])},
                ts.replace(obs=buf))


class RewardClip(Transform):
    """Clip the served reward to ``[lo, hi]``; ``episode_return`` stays
    the raw return."""

    name = "reward_clip"

    def __init__(self, lo: float = -1.0, hi: float = 1.0):
        self.lo, self.hi = float(lo), float(hi)

    def apply(self, state, ts, spec):
        return state, ts.replace(reward=torch.clamp(ts.reward, self.lo,
                                                    self.hi))


class ObsCast(Transform):
    """Cast observations to ``dtype``, then ``obs * scale + offset`` in
    that dtype, two ops as in the JAX package (bitwise); the spec's
    bounds follow, swapped for a negative scale."""

    name = "obs_cast"

    def __init__(self, dtype: torch.dtype = torch.float32,
                 scale: float = 1.0, offset: float = 0.0):
        self.dtype = dtype
        self.scale = float(scale)
        self.offset = float(offset)

    def transform_spec(self, spec):
        o = spec.obs_spec
        lo = None if o.minimum is None else o.minimum * self.scale \
            + self.offset
        hi = None if o.maximum is None else o.maximum * self.scale \
            + self.offset
        if lo is not None and hi is not None and lo > hi:
            lo, hi = hi, lo
        return dataclasses.replace(spec, obs_spec=dataclasses.replace(
            o, dtype=self.dtype, minimum=lo, maximum=hi))

    def apply(self, state, ts, spec):
        obs = ts.obs.to(self.dtype)
        # 0-dim tensors of the target dtype, so that an integer dtype
        # stays integer (jnp.asarray(scale, dtype) in the JAX package)
        if self.scale != 1.0:
            obs = obs * torch.tensor(self.scale, dtype=self.dtype)
        if self.offset != 0.0:
            obs = obs + torch.tensor(self.offset, dtype=self.dtype)
        return state, ts.replace(obs=obs)


class EpisodicLife(Transform):
    """Serve a life loss as an episode end without resetting the env:
    ``reward < threshold`` (a point conceded in Pong) is ORed into the
    served ``done`` and ``terminated``.  Place it before ``FrameStack`` to
    restart the stack on a life loss too."""

    name = "episodic_life"

    def __init__(self, threshold: float = 0.0):
        self.threshold = float(threshold)

    def apply(self, state, ts, spec):
        lost = ts.reward < self.threshold
        return state, ts.replace(done=ts.done | lost,
                                 terminated=ts.terminated | lost)


class NormalizeObs(Transform):
    """Normalize observations by running moments: pool-global
    ``(count, mean, m2)`` in f32, each served block merged in by Chan's
    parallel formula and then normalized with the moments that include
    it, ``(x - mean) / sqrt(max(m2 / count, 0) + eps)``, clipped to
    ``[-clip, clip]``.  The block's sums run in torch's order, not XLA's,
    so the values agree with the JAX package's to f32 reduction-order
    tolerance.

    Over a mesh of D > 1 shards each shard holds a copy of the moments
    and serves M/D rows; the block's count, sum and squared deviations
    are merged across the shards (the JAX package's ``psum``) by two
    gathers of the ``(D, *obs)`` per-shard sums, added in shard order,
    so the copies stay equal and the result does not depend on how the
    shards are dealt to processes.  Statistics cross, never env data."""

    name = "normalize_obs"

    def __init__(self, eps: float = 1e-8, clip: float | None = 10.0):
        self.eps = float(eps)
        self.clip = None if clip is None else float(clip)

    def transform_spec(self, spec):
        lim = self.clip
        return dataclasses.replace(spec, obs_spec=dataclasses.replace(
            spec.obs_spec, dtype=torch.float32,
            minimum=None if lim is None else -lim, maximum=lim))

    def init(self, spec, num_envs, device):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        shape = spec.obs_spec.shape
        return {"count": zeros(()), "mean": zeros(shape), "m2": zeros(shape)}

    def apply(self, state, ts, spec, mesh=None):
        if mesh is not None:
            return self._apply_shards(state, ts, mesh)
        x = ts.obs.to(torch.float32)
        nb = float(x.shape[0])
        bmean = x.sum(0) / nb
        d2 = ((x - bmean) ** 2).sum(0)
        return self._merge(state, x, nb, bmean, d2, ts)

    def _apply_shards(self, state, ts, mesh):
        d = mesh.local_shards
        x = ts.obs.to(torch.float32)
        xs = x.reshape((d, -1) + tuple(x.shape[1:]))
        nb = float(xs.shape[1] * mesh.num_shards)
        bmean = mesh.gather(xs.sum(1), "moments").sum(0) / nb
        d2 = mesh.gather(((xs - bmean) ** 2).sum(1), "moments").sum(0)
        # the copies are equal: merge into shard 0's, hand it to all
        new, ts = self._merge({k: v[0] for k, v in state.items()}, x, nb,
                              bmean, d2, ts)
        return {k: v.expand((d,) + tuple(v.shape)).clone()
                for k, v in new.items()}, ts

    def _merge(self, state, x, nb, bmean, d2, ts):
        count, mean0 = state["count"], state["mean"]
        total = count + nb
        delta = bmean - mean0
        mean = mean0 + delta * (nb / total)
        m2 = state["m2"] + d2 + delta * delta * (count * nb / total)
        var = torch.clamp_min(m2 / total, 0.0)
        norm = (x - mean) / torch.sqrt(var + self.eps)
        if self.clip is not None:
            norm = torch.clamp(norm, -self.clip, self.clip)
        return ({"count": total, "mean": mean, "m2": m2},
                ts.replace(obs=norm))


class Grayscale(Transform):
    """RGB -> ALE luma: ``(..., H, W, 3) uint8 -> (..., H, W) uint8``
    through the ``grayscale`` kernel."""

    name = "grayscale"

    def transform_spec(self, spec):
        o = spec.obs_spec
        if len(o.shape) < 3 or o.shape[-1] != 3:
            raise ValueError(
                f"Grayscale wants (..., H, W, 3) observations; got {o.shape}")
        if o.dtype != torch.uint8:
            raise ValueError(f"Grayscale wants uint8 observations; got "
                             f"{o.dtype}")
        return dataclasses.replace(
            spec, obs_spec=dataclasses.replace(o, shape=o.shape[:-1]))

    def apply(self, state, ts, spec):
        from repro_torch.kernels.image.ops import grayscale

        return state, ts.replace(obs=grayscale(ts.obs))


class Resize(Transform):
    """Fixed-point resampling of the trailing (H, W) dims to ``(h, w)``
    (``area`` or ``bilinear``) through the ``resize`` kernel."""

    name = "resize"

    def __init__(self, h: int, w: int, method: str = "area"):
        if h < 1 or w < 1:
            raise ValueError(f"Resize needs h, w >= 1; got ({h}, {w})")
        if method not in RESIZE_METHODS:
            raise ValueError(
                f"unknown resize method {method!r}; known: {RESIZE_METHODS}")
        self.h, self.w = int(h), int(w)
        self.method = method

    def transform_spec(self, spec):
        o = spec.obs_spec
        if len(o.shape) < 2:
            raise ValueError(
                f"Resize wants (..., H, W) observations; got {o.shape}")
        if o.dtype != torch.uint8:
            raise ValueError(f"Resize wants uint8 observations; got "
                             f"{o.dtype}")
        return dataclasses.replace(spec, obs_spec=dataclasses.replace(
            o, shape=o.shape[:-2] + (self.h, self.w)))

    def apply(self, state, ts, spec):
        from repro_torch.kernels.image.ops import resize

        return state, ts.replace(obs=resize(ts.obs, self.h, self.w,
                                            self.method))


class Crop(Transform):
    """Static-window crop of the trailing (H, W) dims through the
    ``crop`` kernel: ``(..., H, W) -> (..., height, width)``, the window
    checked against the input spec when the pipeline is built."""

    name = "crop"

    def __init__(self, top: int, left: int, height: int, width: int):
        self.top, self.left = int(top), int(left)
        self.height, self.width = int(height), int(width)

    def transform_spec(self, spec):
        o = spec.obs_spec
        if len(o.shape) < 2:
            raise ValueError(
                f"Crop wants (..., H, W) observations; got {o.shape}")
        if o.dtype != torch.uint8:
            raise ValueError(f"Crop wants uint8 observations; got "
                             f"{o.dtype}")
        check_crop(o.shape[-2], o.shape[-1], self.top, self.left,
                   self.height, self.width)
        return dataclasses.replace(spec, obs_spec=dataclasses.replace(
            o, shape=o.shape[:-2] + (self.height, self.width)))

    def apply(self, state, ts, spec):
        from repro_torch.kernels.image.ops import crop

        return state, ts.replace(obs=crop(ts.obs, self.top, self.left,
                                          self.height, self.width))


class TransformPipeline:
    """An ordered list of transforms bound to one env spec: ``init`` the
    per-pool state tuple, ``gather``/``scatter`` the per-lane rows of a
    served block, ``apply`` the stages in order.  ``mesh``: the pool's
    ``EnvMesh`` when it has more than one shard, handed to the stages
    with global state."""

    def __init__(self, transforms: Sequence[Transform], spec: EnvSpec,
                 mesh: Any = None):
        self.mesh = mesh
        self.transforms = tuple(transforms)
        for t in self.transforms:
            if not isinstance(t, Transform):
                raise TypeError(
                    f"transforms must be Transform instances, got {t!r}")
        self.in_spec = spec
        stage_specs = []
        s = spec
        for t in self.transforms:
            stage_specs.append(s)
            s = t.transform_spec(s)
            if s.act_spec is not spec.act_spec:
                raise ValueError(
                    f"transform {t.name!r} must not change act_spec")
        self.stage_specs = tuple(stage_specs)
        self.out_spec = s

    def __bool__(self) -> bool:
        return bool(self.transforms)

    def init(self, num_envs: int, device: torch.device) -> tuple:
        return tuple(t.init(s, num_envs, device)
                     for t, s in zip(self.transforms, self.stage_specs))

    def gather(self, tf_state: tuple, idx: torch.Tensor) -> tuple:
        return tuple(tree_gather(s, idx) if t.per_lane else s
                     for t, s in zip(self.transforms, tf_state))

    def scatter(self, tf_state: tuple, idx: torch.Tensor,
                block: tuple) -> tuple:
        return tuple(tree_scatter(full, idx, blk) if t.per_lane else blk
                     for t, full, blk in zip(self.transforms, tf_state,
                                             block))

    def apply(self, block: tuple, ts: TimeStep) -> tuple[tuple, TimeStep]:
        new = []
        for t, s, spec in zip(self.transforms, block, self.stage_specs):
            if self.mesh is None or t.per_lane or not tree_leaves(s):
                s, ts = t.apply(s, ts, spec)
            else:
                s, ts = t.apply(s, ts, spec, mesh=self.mesh)
            new.append(s)
        return tuple(new), ts


def resolve_transforms(transforms: Sequence[Transform] | None,
                       default: Sequence[Transform] = ()
                       ) -> tuple[Transform, ...]:
    """``None`` selects the task's registered pipeline; an explicit
    sequence (``[]`` for the raw stream) replaces it."""
    return tuple(default if transforms is None else transforms)


__all__ = [
    "Crop", "EpisodicLife", "FrameStack", "Grayscale", "NormalizeObs",
    "ObsCast", "Resize", "RewardClip", "Transform", "TransformPipeline",
    "resolve_transforms",
]
