"""The port's image family (kernels/image) against the JAX package's
Pallas kernels in interpret mode: render, grayscale and resize, all
bitwise (integer fixed point and exact f32 compares), and the resize
weight tables equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_wrappers_refuse_the_kernel_for_cpu_tensors():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ops.grayscale(x, backend="cuda")
    with pytest.raises(ValueError):
        ops.resize(x[..., 0], 2, 2, backend="cuda")
    with pytest.raises(ValueError):
        ops.grayscale(x[..., 0])          # no channel dim


def test_launch_signatures_match_the_c_entry_points():
    """ctypes passes what each ``extern "C"`` entry declares: a pointer or
    stream as c_void_p, ``int`` as c_int and ``long long`` as c_longlong.
    A mismatch truncates silently; grayscale's pixel count passes 2^31
    for a 210x160 block of 63.9k lanes, so it must be 64-bit."""
    import ctypes
    import re

    from repro_torch.kernels.build import CSRC, SIGNATURES

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
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
