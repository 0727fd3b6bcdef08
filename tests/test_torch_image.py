"""The port's image family (kernels/image) against the JAX package's
Pallas kernels in interpret mode: render, grayscale, crop and resize,
all bitwise (integer fixed point and exact f32 compares), and the resize
weight tables equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.image import ops as jops  # noqa: E402
from repro.kernels.image import ref as jref  # noqa: E402
from repro_torch.kernels.image import ops, ref  # noqa: E402

INTERPRET = "pallas-interpret"


def rand_u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("in_size,out_size,method", [
    (210, 84, "area"), (160, 84, "area"), (210, 84, "bilinear"),
    (37, 11, "area"), (29, 17, "bilinear"),
])
def test_resize_weights_equal(in_size, out_size, method):
    np.testing.assert_array_equal(
        ref.resize_weights(in_size, out_size, method),
        jref.resize_weights(in_size, out_size, method))


@pytest.mark.parametrize("shape", [(5, 37, 29, 3), (3, 210, 160, 3)])
def test_grayscale_bitwise(shape):
    rgb = rand_u8(shape, seed=len(shape))
    want = np.asarray(jops.grayscale(jnp.asarray(rgb), backend=INTERPRET))
    np.testing.assert_array_equal(ops.grayscale(torch.from_numpy(rgb))
                                  .numpy(), want)


@pytest.mark.parametrize("h,w,oh,ow,method", [
    (210, 160, 84, 84, "area"), (210, 160, 84, 84, "bilinear"),
    (37, 29, 11, 17, "area"), (37, 29, 11, 17, "bilinear"),
])
def test_resize_bitwise(h, w, oh, ow, method):
    img = rand_u8((3, h, w), seed=h + w)
    want = np.asarray(jops.resize(jnp.asarray(img), oh, ow, method,
                                  backend=INTERPRET))
    got = ops.resize(torch.from_numpy(img), oh, ow, method)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pong_render_bitwise():
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 84, (4, 16)).astype(np.float32)
    # whole and half grid positions put compares exactly on an edge
    pos[:, :8] = np.round(pos[:, :8] * 2) / 2
    want = np.asarray(jops.pong_render(*map(jnp.asarray, pos),
                                       backend=INTERPRET))
    got = ops.pong_render(*map(torch.from_numpy, pos))
    assert got.shape == (16, 210, 160, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,window", [
    ((3, 210, 160), (34, 0, 160, 160)),    # the Pong playfield
    ((2, 3, 37, 29), (5, 3, 11, 17)),      # odd window, leading dims
    ((4, 8, 8), (0, 0, 8, 8)),             # the whole image
])
def test_crop_bitwise(shape, window):
    img = rand_u8(shape, seed=sum(shape))
    want = np.asarray(jops.crop(jnp.asarray(img), *window,
                                backend=INTERPRET))
    got = ops.crop(torch.from_numpy(img), *window)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_refuses_a_window_outside_the_image():
    with pytest.raises(ValueError, match="out of bounds"):
        ops.crop(torch.zeros((2, 8, 8), dtype=torch.uint8), 4, 0, 5, 8)


def test_pong_stream_with_crop_matches_repro():
    """The classic pipeline with the playfield cropped out of the
    grayscale screen, against repro.make run live: 20 steps, every
    field bitwise."""
    import jax

    import repro.core.registry as jax_registry
    import repro.core.transforms as jtf
    import repro_torch

    def pipeline(m):
        return [m.Grayscale(), m.Crop(34, 0, 160, 160), m.Resize(84, 84),
                m.FrameStack(4), m.RewardClip()]

    jp = jax_registry.make("PongClassic-v5", num_envs=4, batch_size=2,
                           obs=False, transforms=pipeline(jtf),
                           max_episode_steps=5)
    tp = repro_torch.make("PongClassic-v5", num_envs=4, batch_size=2,
                          device="cpu", transforms=pipeline(repro_torch),
                          max_episode_steps=5)
    assert tp.spec.obs_spec.shape == jp.spec.obs_spec.shape == (4, 84, 84)
    jps, jts = jp.reset(jax.random.PRNGKey(1))
    tps, tts = tp.reset(repro_torch.random.PRNGKey(1))
    jstep = jax.jit(jp.step)
    for t in range(20):
        for f in ("obs", "reward", "done", "env_id", "step_cost"):
            np.testing.assert_array_equal(getattr(tts, f).numpy(),
                                          np.asarray(getattr(jts, f)),
                                          err_msg=f"step {t} {f}")
        a = ((np.asarray(jts.env_id) * 5 + t) % 6).astype(np.int32)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts.env_id)


def test_wrappers_refuse_the_kernel_for_cpu_tensors():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ops.grayscale(x, backend="cuda")
    with pytest.raises(ValueError):
        ops.resize(x[..., 0], 2, 2, backend="cuda")
    with pytest.raises(ValueError):
        ops.crop(x[..., 0], 0, 0, 2, 2, backend="cuda")
    with pytest.raises(ValueError):
        ops.grayscale(x[..., 0])          # no channel dim


def test_launch_signatures_match_the_c_entry_points():
    """ctypes passes what each ``extern "C"`` entry declares: a pointer or
    stream as c_void_p, ``int`` as c_int, ``long long`` as c_longlong and
    ``float`` as c_float.
    A mismatch truncates silently; grayscale's pixel count passes 2^31
    for a 210x160 block of 63.9k lanes, so it must be 64-bit."""
    import ctypes
    import re

    from repro_torch.kernels.build import CSRC, SIGNATURES

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    declared = {}
    for src in CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            declared[name] = tuple(
                ctypes.c_void_p if "*" in p
                else kinds[" ".join(p.split()[:-1]).replace("const ", "")]
                for p in params.split(","))
    assert declared == SIGNATURES
    assert SIGNATURES["grayscale_launch"][2] is ctypes.c_longlong


@pytest.mark.parametrize("in_size,out_size,method", [
    (210, 84, "area"), (160, 84, "area"), (210, 84, "bilinear"),
    (160, 84, "bilinear"), (37, 11, "area"), (29, 17, "area"),
    (37, 11, "bilinear"), (29, 17, "bilinear"), (5, 50, "bilinear"),
    (1, 3, "area"), (84, 84, "area"), (2, 1, "area"), (2, 1, "bilinear"),
    (3, 7, "area"), (3, 7, "bilinear"), (64, 32, "area"),
    (64, 32, "bilinear"), (100, 33, "area"), (250, 84, "area"),
    (250, 84, "bilinear"), (11, 11, "bilinear"), (160, 160, "area"),
])
def test_compact_taps_expand_to_the_weights(in_size, out_size, method):
    """The kernel's taps (first tap and a band of K weights per output
    row, padded to the fast path's 3 where the band is narrower) expand
    back to ``resize_weights`` exactly, and every band lies inside the
    input."""
    first, taps = ops.compact_taps(in_size, out_size, method)
    k = taps.shape[1]
    assert first.shape == (out_size,) and taps.shape == (out_size, k)
    assert k >= min(ops.FAST_TAPS, in_size)
    assert np.all(first >= 0) and np.all(first + k <= in_size)
    dense = np.zeros((out_size, in_size), np.int64)
    for o in range(out_size):
        dense[o, first[o]:first[o] + k] = taps[o]
    np.testing.assert_array_equal(dense,
                                  ref.resize_weights(in_size, out_size,
                                                     method))


def test_compact_taps_band_widths():
    """The main path's bands: 3 taps for area 210 -> 84 and 160 -> 84, 2
    for bilinear (padded to 3 with a zero weight); 5 for area 37 -> 11."""
    assert ops.compact_taps(210, 84, "area")[1].shape[1] == 3
    assert ops.compact_taps(160, 84, "area")[1].shape[1] == 3
    bilinear = ops.compact_taps(210, 84, "bilinear")[1]
    assert bilinear.shape[1] == 3
    assert np.all((bilinear != 0).sum(axis=1) <= 2)
    assert ops.compact_taps(37, 11, "area")[1].shape[1] == 5


def test_device_taps_table():
    """One int32 row per output row, then per output column: its first
    input, then its band; the fast path's rows are 4 ints (16 bytes)."""
    taps, ka, kb = ops._device_taps(210, 160, 84, 84, "area",
                                    torch.device("cpu"))
    assert (ka, kb) == (3, 3)
    rows = taps.numpy().reshape(168, 4)
    for table, (n_in, n_out) in ((rows[:84], (210, 84)),
                                 (rows[84:], (160, 84))):
        first, band = ops.compact_taps(n_in, n_out, "area")
        np.testing.assert_array_equal(table[:, 0], first)
        np.testing.assert_array_equal(table[:, 1:], band)


@pytest.mark.parametrize("ptr,h,w,bulk", [
    (0, 210, 160, True),        # the Pong screen: 33,600 = 2100 x 16 B
    (4096, 160, 160, True),     # the cropped playfield
    (1, 210, 160, False),       # a batch one byte into its buffer
    (8, 210, 160, False),       # 8-byte aligned is not enough
    (0, 37, 29, False),         # 1,073 B: not a multiple of 16
    (0, 300, 400, True),        # a 120 KB image
])
def test_bulk_copies_predicate(ptr, h, w, bulk):
    assert ops.bulk_copies(ptr, h, w) is bulk


@pytest.mark.parametrize("rgb_ptr,out_ptr,n,vec", [
    (0, 0, 1024 * 210 * 160, True),      # the PongClassic sync block
    (4096, 512, 210 * 160, True),        # one screen
    (1, 0, 1024 * 210 * 160, False),     # a batch one byte into its buffer
    (0, 1, 1024 * 210 * 160, False),     # an output one byte in
    (8, 0, 210 * 160, False),            # 8-byte aligned is not enough
    (0, 0, 3 * 7 * 5, False),            # 105 pixels: not a multiple of 16
    (0, 0, 16, True),
    (0, 0, 24, False),
])
def test_grayscale_vector_path_predicate(rgb_ptr, out_ptr, n, vec):
    assert ops.vector_pixels(rgb_ptr, out_ptr, n) is vec


@pytest.mark.parametrize("n,vec,sms,blocks", [
    (1024 * 210 * 160, True, 132, 132 * ops.GRAY_BLOCKS_PER_SM),
    (210 * 160, True, 132, 5),           # 33,600 pixels, 8,192 a block
    (105, False, 132, 1),
    (1 << 20, False, 132, 132 * ops.GRAY_BLOCKS_PER_SM),
    (0, True, 132, 1),
])
def test_grayscale_plan(n, vec, sms, blocks):
    """Persistent blocks: one turn of every thread's loop, at most what
    the card holds at once."""
    assert ops.gray_plan(n, vec, sms) == blocks


@pytest.mark.parametrize("n,sms", [
    (1, 132), (5, 132), (33, 132), (1024, 132), (4096, 132), (1024, 2),
    (7, 1), (100, 114),
])
def test_render_plan_covers_every_row_once(n, sms):
    """Warp w of the launch renders rows [w * rows, (w + 1) * rows) of
    the n * 210, cut at the end: every row once, no block without a row,
    and no more warps than one wave of ``RENDER_BLOCKS_PER_SM`` blocks an
    SM unless each already takes a single row."""
    blocks, rows = ops.render_plan(n, sms)
    total = n * ref.RGB_H
    warps = blocks * ops.RENDER_WARPS
    owner = np.full(total, -1)
    for w in range(warps):
        span = slice(w * rows, min((w + 1) * rows, total))
        assert np.all(owner[span] == -1)
        owner[span] = w
    assert np.all(owner >= 0)
    assert (blocks - 1) * ops.RENDER_WARPS * rows < total
    resident = sms * ops.RENDER_BLOCKS_PER_SM * ops.RENDER_WARPS
    assert warps <= resident + ops.RENDER_WARPS or rows == 1
    assert rows == 1 or (rows - 1) * resident < total


def test_render_plan_at_the_main_path():
    """PongClassic N=1024 on a 132-SM H100: 102 rows a warp, 264 blocks,
    one wave of 2 blocks of 8 warps an SM."""
    assert ops.render_plan(1024, 132) == (264, 102)
    assert 264 <= 132 * ops.RENDER_BLOCKS_PER_SM


def crop_claims_hold(path, img_ptr, out_ptr, h, w, top, left, height,
                     width):
    """What ``csrc/image.cu::crop_launch`` needs of each unit, stated
    on the byte addresses every image's window reads and writes."""
    if path == ops.CROP_BYTES:
        return True
    unit = 4 if path == ops.CROP_WORDS else 16
    for image in range(3):
        src = img_ptr + image * h * w + top * w + left
        dst = out_ptr + image * height * width
        if path == ops.CROP_RUNS:
            if left != 0 or width != w or (height * width) % unit:
                return False
            starts = [(src, dst)]
        else:
            if width % unit:
                return False
            starts = [(src + y * w, dst + y * width) for y in range(height)]
        if any(s % unit or d % unit for s, d in starts):
            return False
    return True


@pytest.mark.parametrize("img_ptr,out_ptr,window,path", [
    (0, 0, (34, 0, 160, 160), ops.CROP_RUNS),     # the Pong playfield
    (4096, 512, (0, 0, 210, 160), ops.CROP_RUNS),  # the whole screen
    (0, 0, (3, 16, 101, 32), ops.CROP_SPANS),
    (0, 0, (34, 0, 160, 144), ops.CROP_SPANS),    # not the full width
    (8, 0, (34, 0, 160, 160), ops.CROP_WORDS),    # 8-byte aligned input
    (0, 0, (3, 4, 101, 36), ops.CROP_WORDS),
    (0, 0, (3, 5, 101, 37), ops.CROP_BYTES),
    (1, 0, (34, 0, 160, 160), ops.CROP_BYTES),    # one byte into a buffer
    (0, 2, (3, 16, 101, 32), ops.CROP_BYTES),
])
def test_crop_plan_paths(img_ptr, out_ptr, window, path):
    assert ops.crop_plan(img_ptr, out_ptr, 210, 160, *window) == path


@pytest.mark.parametrize("h,w,window", [
    (210, 160, (34, 0, 160, 160)), (210, 160, (3, 16, 101, 32)),
    (210, 160, (3, 4, 101, 36)), (210, 160, (3, 5, 101, 37)),
    (7, 84, (1, 0, 4, 84)),       # whole rows, a 336-byte run ...
    (7, 84, (2, 0, 4, 84)),       # ... 168 bytes past 16-byte alignment
    (5, 84, (0, 0, 4, 84)),       # 420-byte images: runs drift
    (9, 48, (0, 0, 9, 48)), (37, 29, (5, 3, 11, 17)),
])
def test_crop_plan_never_claims_a_missing_alignment(h, w, window):
    """Over pointers 0..31 bytes into a buffer, the plan's unit holds for
    every image's window, and it is the widest that does."""
    for img_ptr in range(32):
        for out_ptr in (0, 4, 16, 17):
            path = ops.crop_plan(img_ptr, out_ptr, h, w, *window)
            assert crop_claims_hold(path, img_ptr, out_ptr, h, w, *window)
            wider = [p for p in (ops.CROP_RUNS, ops.CROP_SPANS,
                                 ops.CROP_WORDS) if p < path]
            for p in wider:
                assert not crop_claims_hold(p, img_ptr, out_ptr, h, w,
                                            *window)
