"""Plain PyTorch versions of the batched image kernels and their shared
fixed-point definitions (``repro/kernels/image/ref.py``).

Every op here is integer fixed point, or exact f32 compares, so the
plain versions, the CUDA kernels (``csrc/image.cu``) and the JAX package
give bit-identical uint8 outputs:

  * grayscale — ALE luma ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``;
  * crop — a static window of the trailing (H, W) dims, a copy;
  * resize — separable ``round_shift(A @ x)`` then ``round_shift(t @ Bᵀ)``
    with 8-bit weight rows that sum to exactly 2^8.  The plain version
    runs the two products in float32, exact because every partial sum is
    an integer below 2^24 — but only in true f32, so on the card it
    refuses to run while TF32 matmuls are allowed;
  * the Pong render — the native 210 x 160 RGB screen from four game
    scalars by f32 compares and selects.

``resize_weights`` is this package's own copy of the weight tables,
built with numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GRAY_SHIFT = 15
GRAY_R, GRAY_G, GRAY_B = 9798, 19235, 3735   # sums to exactly 2**15

RESIZE_SHIFT = 8
RESIZE_METHODS = ("area", "bilinear")

# the native ALE screen and Pong palette, drawn from the 84-grid game
# state of envs/atari_like.py scaled by (RGB_H/84, RGB_W/84)
RGB_H, RGB_W = 210, 160
_GAME_H = _GAME_W = 84.0
_PADDLE_HALF = 6.0
PONG_BG = (144, 72, 17)
PONG_PLAYER = (92, 186, 92)
PONG_ENEMY = (213, 130, 74)
PONG_BALL = (236, 236, 236)

# render constants, each rounded to f32 as the JAX package rounds them
SY = np.float32(RGB_H / _GAME_H)
SX = np.float32(RGB_W / _GAME_W)
PAD_REACH = np.float32(_PADDLE_HALF) * SY
PLAYER_X = np.float32(RGB_W) - np.float32(3.0) * SX
ENEMY_X = np.float32(2.0) * SX


# ---------------------------------------------------------------------- #
# grayscale
# ---------------------------------------------------------------------- #
def grayscale_reference(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 luma, integer fixed point."""
    x = rgb.to(torch.int32)
    y = (GRAY_R * x[..., 0] + GRAY_G * x[..., 1] + GRAY_B * x[..., 2]
         + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return y.to(torch.uint8)


# ---------------------------------------------------------------------- #
# resize weight tables
# ---------------------------------------------------------------------- #
def _quantize_row(w: np.ndarray, shift: int) -> np.ndarray:
    """One non-negative weight row in int fixed point summing to exactly
    ``2**shift`` (largest-remainder rounding, stable tie-break)."""
    total = 1 << shift
    w = w / w.sum()
    scaled = w * total
    base = np.floor(scaled).astype(np.int64)
    rem = scaled - base
    deficit = total - int(base.sum())
    order = np.argsort(-rem, kind="stable")
    base[order[:deficit]] += 1
    return base


def _bilinear_rows(in_size: int, out_size: int) -> np.ndarray:
    """Half-pixel-center bilinear taps (<= 2 per row, edge clamped)."""
    rows = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        f = src - i0
        for j, wj in ((i0, 1.0 - f), (i0 + 1, f)):
            if wj > 0:
                rows[i, min(max(j, 0), in_size - 1)] += wj
    return rows


def _area_rows(in_size: int, out_size: int) -> np.ndarray:
    """Fractional box coverage of ``[i*scale, (i+1)*scale)``."""
    rows = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), in_size)):
            cover = min(hi, j + 1.0) - max(lo, float(j))
            if cover > 0:
                rows[i, j] = cover / scale
    return rows


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int, method: str = "area",
                   shift: int = RESIZE_SHIFT) -> np.ndarray:
    """Read-only ``(out_size, in_size)`` int32 resampling matrix whose
    rows each sum to exactly ``2**shift``."""
    if method not in RESIZE_METHODS:
        raise ValueError(
            f"unknown resize method {method!r}; known: {RESIZE_METHODS}")
    if in_size < 1 or out_size < 1:
        raise ValueError(f"bad resize {in_size} -> {out_size}")
    rows = (_area_rows if method == "area" else _bilinear_rows)(
        in_size, out_size)
    q = np.stack([_quantize_row(r, shift) for r in rows]).astype(np.int32)
    q.setflags(write=False)
    return q


def _round_shift(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.int32) + (1 << (RESIZE_SHIFT - 1))) >> RESIZE_SHIFT


def resize_reference(img: torch.Tensor, out_h: int, out_w: int,
                     method: str = "area") -> torch.Tensor:
    """(..., H, W) uint8 -> (..., out_h, out_w) uint8, two f32 products
    that are integer-exact by bounds."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("resize_reference needs true f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    h, w = img.shape[-2], img.shape[-1]
    a = torch.tensor(resize_weights(h, out_h, method), dtype=torch.float32,
                     device=img.device)
    b = torch.tensor(resize_weights(w, out_w, method), dtype=torch.float32,
                     device=img.device)
    t = _round_shift(torch.matmul(a, img.to(torch.float32)))
    o = _round_shift(torch.matmul(t.to(torch.float32), b.T))
    return o.to(torch.uint8)


# ---------------------------------------------------------------------- #
# crop
# ---------------------------------------------------------------------- #
def check_crop(in_h: int, in_w: int, top: int, left: int, height: int,
               width: int) -> None:
    if (top < 0 or left < 0 or height < 1 or width < 1
            or top + height > in_h or left + width > in_w):
        raise ValueError(
            f"crop [{top}:{top + height}, {left}:{left + width}] out of "
            f"bounds for ({in_h}, {in_w})")


def crop_reference(img: torch.Tensor, top: int, left: int, height: int,
                   width: int) -> torch.Tensor:
    """Static window of the trailing (H, W) dims, as a new tensor."""
    check_crop(img.shape[-2], img.shape[-1], top, left, height, width)
    return img[..., top:top + height, left:left + width].contiguous()


# ---------------------------------------------------------------------- #
# the Pong RGB render
# ---------------------------------------------------------------------- #
def pong_render_reference(ball_x: torch.Tensor, ball_y: torch.Tensor,
                          paddle_y: torch.Tensor, enemy_y: torch.Tensor
                          ) -> torch.Tensor:
    """(N,) game-state scalars -> (N, 210, 160, 3) uint8 screens."""
    dev = ball_x.device
    ys = torch.arange(RGB_H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(RGB_W, dtype=torch.float32, device=dev)[None, :]

    def e(v):
        return v.to(torch.float32)[..., None, None]

    sy, sx = float(SY), float(SX)
    ball = ((torch.abs(ys - e(ball_y) * sy) <= sy)
            & (torch.abs(xs - e(ball_x) * sx) <= sx))
    pad = ((torch.abs(ys - e(paddle_y) * sy) <= float(PAD_REACH))
           & (xs >= float(PLAYER_X)))
    enemy = ((torch.abs(ys - e(enemy_y) * sy) <= float(PAD_REACH))
             & (xs <= float(ENEMY_X)))
    planes = []
    for c in range(3):
        v = torch.where(ball, PONG_BALL[c], torch.where(
            pad, PONG_PLAYER[c], torch.where(enemy, PONG_ENEMY[c],
                                             PONG_BG[c])))
        planes.append(v.to(torch.uint8))
    return torch.stack(planes, dim=-1)


__all__ = [
    "GRAY_B", "GRAY_G", "GRAY_R", "GRAY_SHIFT", "PONG_BALL", "PONG_BG",
    "PONG_ENEMY", "PONG_PLAYER", "RESIZE_METHODS", "RESIZE_SHIFT", "RGB_H",
    "RGB_W", "check_crop", "crop_reference", "grayscale_reference",
    "pong_render_reference",
    "resize_reference", "resize_weights",
]
