"""The port's plain decode attention (``kernels/decode_attention``)
against the JAX package's, run live: its Pallas kernel in interpret
mode and its jnp reference, over batch, GQA group, cache length (T not
a multiple of 64 included), head dim, dtype and ragged lengths with 0
and T.

Tolerances: float32 atol 1e-5 (the sums run in another order); bfloat16
one bf16 ulp of the output plus that same 1e-5 (all versions compute in
f32 and round once to bf16, so a last-bit difference in the f32 value
can flip the rounding; near-zero outputs come from cancellation, where
the f32 error of 1e-5 exceeds a bf16 ulp of the output).  A length-0
lane is exactly 0 in all versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    default_scale,
)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def inputs(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32)
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[: 3] = (0, 1, T)[: B]
    return q, k, v, lengths


def to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    exp = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (exp - 7)


@pytest.mark.parametrize("B,H,Hkv,T,D", [
    (1, 2, 2, 64, 16),       # G = 1
    (3, 4, 2, 37, 16),       # G = 2, T not a multiple of 64
    (4, 8, 2, 100, 128),     # G = 4
    (5, 16, 8, 161, 128),    # qwen3-0.6b heads, the serve cache length
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jax_backend", ["pallas-interpret", "reference"])
def test_matches_repro(B, H, Hkv, T, D, dtype, jax_backend):
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, lengths = inputs(B, H, Hkv, T, D, seed=B * T + D)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lengths), block_t=T, backend=jax_backend
    ).astype(jnp.float32))
    got = ops.decode_attention(to_torch(q, tdt), to_torch(k, tdt),
                               to_torch(v, tdt), torch.from_numpy(lengths))
    assert got.dtype == tdt and got.shape == (B, H, D)
    got = got.float().numpy()
    assert np.all(got[lengths == 0] == 0.0)
    assert np.all(want[lengths == 0] == 0.0)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= bf16_ulp(want) + 1e-5)


def test_strided_layer_view_equals_a_dense_copy():
    """``decode_step`` passes layer i of a (B, L, Hkv, T, D) cache: the
    view and a dense copy of it give the same output."""
    rng = np.random.default_rng(3)
    B, L, Hkv, T, D, H = 4, 3, 2, 29, 16, 8
    cache = torch.from_numpy(rng.normal(0, 1, (2, B, L, Hkv, T, D)).astype(
        np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (B, H, D)).astype(np.float32))
    lengths = torch.tensor([0, 5, 29, 17], dtype=torch.int32)
    kv = cache[0][:, 1], cache[1][:, 1]
    assert not kv[0].is_contiguous()
    got = ops.decode_attention(q, *kv, lengths)
    want = ops.decode_attention(q, *(x.contiguous() for x in kv), lengths)
    assert torch.equal(got, want)


def test_scale_is_the_f32_one_over_sqrt_d():
    for d in (16, 64, 128):
        want = float(jnp.float32(1.0) / jnp.sqrt(jnp.float32(d)))
        assert default_scale(d) == want


def test_cuda_backend_refuses_cpu_tensors():
    q, k, v, lengths = inputs(2, 4, 2, 8, 16, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(lengths), backend="cuda")


# rows an NVIDIA H100 SXM stages at once in bf16 D = 128: 132 SMs of
# 228 KB of shared memory
H100_ROWS = ops.resident_rows(132, 233472, 256)


@pytest.mark.parametrize("T", [1, 2, 16, 17, 64, 97, 161, 256, 257, 512,
                               513, 1000, 5000, 32768])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (32, 8), (128, 8)])
def test_split_plan_deals_every_position_once(B, Hkv, T):
    """For lengths up to T, the chunks the kernel's warps take in turn
    (warp w takes chunks w + warps * turn, as csrc/decode_attention.cu
    deals them) cover 0..length exactly once; warps are a power of two
    within the block's limit, fewer than twice as many as T has chunks,
    and the grid fits on the card at once."""
    warps, rows = ops.split_plan(B, Hkv, T, H100_ROWS)
    assert warps in (1, 2, 4, 8)
    assert 1 <= rows <= 32
    for length in {0, 1, T // 3, T - 1, T}:
        chunks = -(-length // rows)
        seen = np.zeros(length, np.int64)
        for w in range(warps):
            n = (chunks - w - 1) // warps + 1 if chunks > w else 0
            for turn in range(n):
                c = w + warps * turn
                seen[c * rows:min((c + 1) * rows, length)] += 1
        assert np.all(seen == 1)
    assert warps < 2 * max(1, -(-T // rows))
    assert B * Hkv * warps * rows <= max(H100_ROWS, B * Hkv * rows)


def test_split_plan_at_the_main_path_shapes():
    assert H100_ROWS == 30096
    assert ops.split_plan(32, 8, 161, H100_ROWS) == (4, 16)   # serve
    assert ops.split_plan(128, 8, 64, H100_ROWS) == (2, 8)    # LM collect
    assert ops.split_plan(4, 2, 1, H100_ROWS) == (1, 16)
    assert ops.split_plan(5, 2, 1000, H100_ROWS) == (8, 16)   # 8 a warp
    assert ops.split_plan(5, 2, 5000, H100_ROWS) == (8, 16)   # 40 a warp
    # a card with half the shared memory halves the warps at the serve
    assert ops.split_plan(32, 8, 161, H100_ROWS // 2) == (2, 16)


@pytest.mark.parametrize("dtype,D,offset,width", [
    (torch.bfloat16, 128, 0, 16),   # the serve's rows: 256 bytes
    (torch.float32, 128, 0, 16),
    (torch.bfloat16, 20, 0, 8),     # 40-byte rows
    (torch.bfloat16, 6, 0, 4),      # 12-byte rows
    (torch.bfloat16, 64, 1, 2),     # one element into the buffer
    (torch.float32, 64, 1, 4),
    (torch.bfloat16, 64, 4, 8),     # 8 bytes in
])
def test_load_width_is_the_widest_aligned_copy(dtype, D, offset, width):
    B, Hkv, T = 2, 3, 10
    n = B * Hkv * T * D
    buf = torch.zeros(offset + n, dtype=dtype)
    assert buf.data_ptr() % 64 == 0          # the CPU allocator's alignment
    k = buf[offset:].view(B, Hkv, T, D)
    assert ops.load_width(k, k) == width


def test_load_width_reads_strides_of_layer_views():
    """Layer i of a (B, L, Hkv, T, D) cache: its batch stride spans
    every layer, and an odd T * D * L in bf16 leaves 16-byte strides
    only when each stride is a multiple of 8 elements."""
    cache = torch.zeros((2, 3, 5, 2, 7, 8), dtype=torch.bfloat16)
    k, v = cache[0][:, 1], cache[1][:, 1]
    assert ops.load_width(k, v) == 16            # every stride 16 B
    cache = torch.zeros((2, 3, 5, 2, 7, 4), dtype=torch.bfloat16)
    k, v = cache[0][:, 1], cache[1][:, 1]
    assert ops.load_width(k, v) == 8             # 8-byte rows
