"""Public wrappers of the batched image kernels (``csrc/image.cu``).

Each op launches its CUDA kernel for CUDA tensors and runs the plain
version (``ref.py``) for CPU tensors; ``backend="reference"`` forces the
plain version on the card.  Each wrapper's ``.launches`` counts its
kernel launches and nothing else.  ``grayscale``, ``crop`` and
``resize`` accept any leading batch dims over the image dims.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.backend import (
    check_launch,
    count_launch,
    launch,
    resolve_backend,
)
from repro_torch.kernels.image.ref import (
    RGB_H,
    RGB_W,
    check_crop,
    crop_reference,
    grayscale_reference,
    pong_render_reference,
    resize_reference,
    resize_weights,
)

@functools.lru_cache(maxsize=None)
def _device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# csrc/image.cu's kRenderWarps, kRenderBlocksPerSm: the render's blocks
# are 8 warps, launched 2 to an SM (its __launch_bounds__)
RENDER_WARPS = 8
RENDER_BLOCKS_PER_SM = 2


def render_plan(n: int, sms: int) -> tuple[int, int]:
    """``(blocks, rows)`` of the render's launch: each warp renders
    ``rows`` consecutive screen rows of the batch's ``n * 210``, as few
    as let every warp of ``RENDER_BLOCKS_PER_SM`` blocks an SM take a
    share; ``blocks`` blocks of ``RENDER_WARPS`` warps cover them all."""
    total = n * RGB_H
    rows = max(1, _cdiv(total, sms * RENDER_BLOCKS_PER_SM * RENDER_WARPS))
    return _cdiv(total, RENDER_WARPS * rows), rows


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def pong_render(ball_x: torch.Tensor, ball_y: torch.Tensor,
                paddle_y: torch.Tensor, enemy_y: torch.Tensor, *,
                backend: str = "auto") -> torch.Tensor:
    """(N,) f32 game-state scalars -> (N, 210, 160, 3) uint8 screens."""
    if resolve_backend(backend, ball_x) != "cuda":
        return pong_render_reference(ball_x, ball_y, paddle_y, enemy_y)
    n = ball_x.shape[0]
    for name, v in (("ball_x", ball_x), ("ball_y", ball_y),
                    ("paddle_y", paddle_y), ("enemy_y", enemy_y)):
        _require(v.shape == (n,) and v.dtype == torch.float32
                 and v.device == ball_x.device and v.is_contiguous(),
                 f"pong_render: {name} must be a contiguous ({n},) f32 "
                 f"tensor on {ball_x.device}; got {tuple(v.shape)} "
                 f"{v.dtype} on {v.device}")
    from repro_torch.kernels.build import library

    out = torch.empty((n, RGB_H, RGB_W, 3), dtype=torch.uint8,
                      device=ball_x.device)
    blocks, rows = render_plan(n, _device_sms(ball_x.device))
    err = launch(
        ball_x, library().pong_render_launch,
        ball_x.data_ptr(), ball_y.data_ptr(), paddle_y.data_ptr(),
        enemy_y.data_ptr(), out.data_ptr(), n, rows, blocks)
    check_launch("pong_render", err)
    count_launch(pong_render)
    return out


# csrc/image.cu's kGrayThreads, kGrayBlocksPerSm
GRAY_THREADS = 256
GRAY_BLOCKS_PER_SM = 4
# pixels a thread takes per turn of the loop on the 16-byte path: two
# groups of 16
GRAY_VECTOR_PIXELS = 32


def vector_pixels(rgb_ptr: int, out_ptr: int, n_pixels: int) -> bool:
    """Whether the grayscale kernel takes 16 pixels a thread by 16-byte
    loads and stores, which needs both pointers 16-byte aligned and a
    pixel count that 16 divides; else it takes a pixel a thread by
    bytes."""
    return rgb_ptr % 16 == 0 and out_ptr % 16 == 0 and n_pixels % 16 == 0


def gray_plan(n_pixels: int, vec: bool, sms: int) -> int:
    """Persistent blocks of the grayscale launch: enough for one turn of
    every thread's loop, at most as many as the card holds at once."""
    per_thread = GRAY_VECTOR_PIXELS if vec else 1
    return max(1, min(_cdiv(n_pixels, GRAY_THREADS * per_thread),
                      sms * GRAY_BLOCKS_PER_SM))


def grayscale(rgb: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., H, W) uint8 ALE luma."""
    _require(rgb.ndim >= 3 and rgb.shape[-1] == 3,
             f"grayscale wants (..., H, W, 3); got {tuple(rgb.shape)}")
    if resolve_backend(backend, rgb) != "cuda":
        return grayscale_reference(rgb)
    _require(rgb.dtype == torch.uint8 and rgb.is_contiguous(),
             f"grayscale wants contiguous uint8; got {rgb.dtype}")
    from repro_torch.kernels.build import library

    out = torch.empty(rgb.shape[:-1], dtype=torch.uint8, device=rgb.device)
    n = out.numel()
    vec = vector_pixels(rgb.data_ptr(), out.data_ptr(), n)
    err = launch(
        rgb, library().grayscale_launch,
        rgb.data_ptr(), out.data_ptr(), n, int(vec),
        gray_plan(n, vec, _device_sms(rgb.device)))
    check_launch("grayscale", err)
    count_launch(grayscale)
    return out


# csrc/image.cu's crop units: (a) whole-row runs and (b) row spans of 16
# bytes, (c) 4-byte words, (d) bytes
CROP_RUNS, CROP_SPANS, CROP_WORDS, CROP_BYTES = range(4)


def crop_plan(img_ptr: int, out_ptr: int, h: int, w: int, top: int,
              left: int, height: int, width: int) -> int:
    """The crop kernel's unit for the window (top, left, height, width)
    of (h, w) images: ``CROP_RUNS`` when the window is whole rows, so
    each image's window is one run of ``height * width`` bytes at
    ``(image * h + top) * w``, every run and both pointers are 16-byte
    aligned and an image's ``h * w`` bytes fit a 32-bit index; else ``CROP_SPANS`` when ``left``, ``width``, ``w``
    and both pointers are multiples of 16, ``CROP_WORDS`` of 4, and
    ``CROP_BYTES`` otherwise."""
    ptrs = img_ptr | out_ptr
    if (left == 0 and width == w and ptrs % 16 == 0
            and (height * width) % 16 == 0 and (top * w) % 16 == 0
            and (h * w) % 16 == 0 and h * w < 2**31):
        return CROP_RUNS
    for path, unit in ((CROP_SPANS, 16), (CROP_WORDS, 4)):
        if (left | width | w | ptrs) % unit == 0:
            return path
    return CROP_BYTES


def crop(img: torch.Tensor, top: int, left: int, height: int, width: int,
         *, backend: str = "auto") -> torch.Tensor:
    """(..., H, W) uint8 -> (..., height, width) uint8, the static window
    at (top, left)."""
    _require(img.ndim >= 2, f"crop wants (..., H, W); got {img.shape}")
    h, w = img.shape[-2], img.shape[-1]
    check_crop(h, w, top, left, height, width)
    if resolve_backend(backend, img) != "cuda":
        return crop_reference(img, top, left, height, width)
    _require(img.dtype == torch.uint8 and img.is_contiguous(),
             f"crop wants contiguous uint8; got {img.dtype}")
    from repro_torch.kernels.build import library

    lead = img.shape[:-2]
    n = img.numel() // (h * w)
    out = torch.empty(lead + (height, width), dtype=torch.uint8,
                      device=img.device)
    path = crop_plan(img.data_ptr(), out.data_ptr(), h, w, top, left,
                     height, width)
    err = launch(img, library().crop_launch, img.data_ptr(),
                 out.data_ptr(), n, h, w, top, left, height, width, path)
    check_launch("crop", err)
    count_launch(crop)
    return out


# bands of up to this many taps are padded to it: the kernel's fast path
# reads a row's first tap and 3 weights as one 16-byte load
FAST_TAPS = 3


def compact_taps(in_size: int, out_size: int, method: str
                 ) -> tuple[np.ndarray, np.ndarray]:
    """``resize_weights`` as the kernel reads it: each output row's first
    tap ``first`` (out_size,) and its band of ``K`` weights ``taps``
    (out_size, K), K the widest band, at least ``FAST_TAPS`` while the
    input has that many, so that ``taps[o, j]`` is the weight of input
    ``first[o] + j``.  A band near the end starts earlier, so ``first + K
    <= in_size``; weights outside a row's band are 0."""
    w = resize_weights(in_size, out_size, method)
    nz = w != 0
    lo = nz.argmax(axis=1)
    hi = in_size - nz[:, ::-1].argmax(axis=1)
    k = min(max(int((hi - lo).max()), FAST_TAPS), in_size)
    first = np.minimum(lo, in_size - k)
    taps = np.take_along_axis(w, first[:, None] + np.arange(k), axis=1)
    return first.astype(np.int32), taps.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_taps(h: int, w: int, out_h: int, out_w: int, method: str,
                 device: torch.device) -> tuple[torch.Tensor, int, int]:
    """The kernel's tap table on ``device``: one int32 row (first input,
    then the band's weights) per output row, then per output column; and
    the band widths (ka, kb)."""
    rows = []
    for n_in, n_out in ((h, out_h), (w, out_w)):
        first, taps = compact_taps(n_in, n_out, method)
        rows.append(np.concatenate([first[:, None], taps], axis=1))
    flat = np.concatenate([r.ravel() for r in rows])
    return (torch.tensor(flat, dtype=torch.int32, device=device),
            rows[0].shape[1] - 1, rows[1].shape[1] - 1)


def bulk_copies(img_ptr: int, h: int, w: int) -> bool:
    """Whether the resize kernel takes its images by 1-D bulk copies,
    which need a 16-byte-aligned image of a multiple of 16 bytes; else a
    byte copy brings them in."""
    return img_ptr % 16 == 0 and (h * w) % 16 == 0


def resize(img: torch.Tensor, out_h: int, out_w: int, method: str = "area",
           *, backend: str = "auto") -> torch.Tensor:
    """(..., H, W) uint8 -> (..., out_h, out_w) uint8 fixed-point
    resampling (``area`` or ``bilinear``)."""
    _require(img.ndim >= 2, f"resize wants (..., H, W); got {img.shape}")
    if resolve_backend(backend, img) != "cuda":
        return resize_reference(img, out_h, out_w, method)
    h, w = img.shape[-2], img.shape[-1]
    _require(img.dtype == torch.uint8 and img.is_contiguous(),
             f"resize wants contiguous uint8; got {img.dtype}")
    taps, ka, kb = _device_taps(h, w, out_h, out_w, method, img.device)
    from repro_torch.kernels.build import library

    lead = img.shape[:-2]
    n = img.numel() // (h * w)
    out = torch.empty(lead + (out_h, out_w), dtype=torch.uint8,
                      device=img.device)
    err = launch(
        img, library().resize_launch,
        img.data_ptr(), taps.data_ptr(), out.data_ptr(), n, h, w, out_h,
        out_w, ka, kb, int(bulk_copies(img.data_ptr(), h, w)))
    check_launch("resize", err)
    count_launch(resize)
    return out


pong_render.launches = 0
grayscale.launches = 0
crop.launches = 0
resize.launches = 0

__all__ = ["CROP_BYTES", "CROP_RUNS", "CROP_SPANS", "CROP_WORDS",
           "bulk_copies", "compact_taps", "crop", "crop_plan", "gray_plan",
           "grayscale", "pong_render", "render_plan", "resize",
           "vector_pixels"]
