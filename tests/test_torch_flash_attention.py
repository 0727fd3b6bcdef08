"""The port's plain flash attention (``kernels/flash_attention``) and its
blocked attention (``models/blocked_attention.py``) against the JAX
package's, run live: its Pallas kernel in interpret mode and its jnp
blocked functions, on the same inputs drawn with numpy.

Tolerances are those of tests/test_kernels.py: float32 atol/rtol 3e-5
(the sums run in another order), bfloat16 atol/rtol 2e-2 (both compute
in f32 and round once to bf16).  A row that sees no key is exactly 0 in
the port and in the TPU kernel; ``repro``'s jnp oracle gives the mean of
V there, the one documented difference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    mha_reference as j_mha_reference,
)
from repro.models import blocked_attention as jblocked  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BF16_EXCESS_TOL,
    mha_reference,
    rounding_excess,
)
from repro_torch.models import blocked_attention as tblocked  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, dict(atol=3e-5, rtol=3e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def inputs(B, H, Hkv, Sq, Skv, D, seed, layout="bhsd"):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))
    else:                                   # the model's (B, S, H, D)
        shapes = ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# the five sweep shapes of tests/test_kernels.py
SWEEP = [
    (2, 4, 2, 256, 64, True, 0),
    (1, 8, 8, 128, 32, True, 0),      # MHA
    (2, 4, 1, 256, 64, True, 64),     # MQA + sliding window
    (1, 2, 2, 192, 16, False, 0),     # bidirectional (encoder)
    (1, 6, 2, 384, 128, True, 128),   # GQA-3 + window, head dim 128
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", SWEEP)
def test_matches_repro_flash_kernel(B, H, Hkv, S, D, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(inputs(B, H, Hkv, S, S, D, seed=S + D),
                                      dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **DTYPES[dtype][2])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shorter_queries_are_end_aligned(causal, window, dtype):
    """Sq < Skv: query i sits at position i + Skv - Sq."""
    (jq, jk, jv), (tq, tk, tv) = both(inputs(2, 4, 2, 64, 192, 32, seed=7),
                                      dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **DTYPES[dtype][2])


def test_a_row_without_keys_is_zero_as_in_the_tpu_kernel():
    """Sq > Skv, causal: the first Sq - Skv queries see no key.  The TPU
    kernel and the port give 0; repro's jnp oracle the mean of V."""
    (jq, jk, jv), (tq, tk, tv) = both(inputs(1, 2, 1, 128, 64, 16, seed=3),
                                      "f32")
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    got = mha_reference(tq, tk, tv)
    assert np.all(f32(got)[:, :, :64] == 0)
    np.testing.assert_allclose(f32(got), f32(want), atol=3e-5, rtol=3e-5)
    oracle = f32(j_mha_reference(jq, jk, jv))
    np.testing.assert_allclose(oracle[:, :, :64],
                               np.broadcast_to(f32(jv).mean(axis=2,
                                                           keepdims=True),
                                               (1, 2, 64, 16)),
                               atol=1e-6)
    np.testing.assert_allclose(f32(got)[:, :, 64:], oracle[:, :, 64:],
                               atol=3e-5, rtol=3e-5)


def test_scale_argument_matches_the_oracle():
    (jq, jk, jv), (tq, tk, tv) = both(inputs(1, 4, 2, 96, 96, 32, seed=5),
                                      "f32")
    want = j_mha_reference(jq, jk, jv, sm_scale=0.3)
    got = ops.flash_attention(tq, tk, tv, sm_scale=0.3)
    np.testing.assert_allclose(f32(got), f32(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("B,H,Hkv,S,D,W", [
    (1, 4, 2, 256, 32, 64),
    (2, 6, 2, 384, 64, 128),
    (1, 2, 1, 512, 16, 32),
])
def test_banded_attention_matches_repro(B, H, Hkv, S, D, W):
    (jq, jk, jv), (tq, tk, tv) = both(
        inputs(B, H, Hkv, S, S, D, seed=W, layout="bshd"), "f32")
    want = jblocked.banded_attention(jq, jk, jv, window=W, block_q=64)
    got = tblocked.banded_attention(tq, tk, tv, W)
    assert got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (1, 4, 2, 256, 32),
    (2, 8, 8, 128, 64),
    (1, 3, 1, 384, 16),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_online_causal_attention_matches_repro(B, H, Hkv, S, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(
        inputs(B, H, Hkv, S, S, D, seed=S, layout="bshd"), dtype)
    want = jblocked.online_causal_attention(jq, jk, jv, block_q=128,
                                            block_k=64)
    got = tblocked.online_causal_attention(tq, tk, tv)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(got), f32(want), **DTYPES[dtype][2])


def _pv_in_bf16(q, k, v, causal, window, split):
    """A flash kernel's bf16 output with the probabilities fed to P.V as
    bf16 (``split``: plus the bf16 of what rounding left, as
    csrc/flash_attention.cu does), all else in f32."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kk, vv = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    s = q.float() @ kk.transpose(-1, -2) / D ** 0.5
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S,
                                                                   dtype=bool)
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    head = p.bfloat16().float()
    o = head @ vv
    if split:
        o = o + (p - head).bfloat16().float() @ vv
    return (o / p.sum(dim=-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96)])
def test_rounding_excess_tells_a_bf16_p_product(causal, window):
    """The bf16 gate of the kernel checks (chip_smoke.py and
    tests/test_torch_gpu.py): the plain version's own rounding reads
    <= 0 and the split P.V product stays under ``BF16_EXCESS_TOL``; a
    P.V product on bf16 probabilities exceeds it, though its largest
    absolute error is within 2e-2 of the plain version's."""
    _, (q, k, v) = both(inputs(1, 4, 2, 512, 512, 128, seed=13), "bf16")
    exact = mha_reference(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
    plain = mha_reference(q, k, v, causal=causal, window=window)
    assert torch.equal(plain, exact.bfloat16())
    assert rounding_excess(plain, exact) <= 1e-6
    split = _pv_in_bf16(q, k, v, causal, window, split=True)
    assert rounding_excess(split, exact) < BF16_EXCESS_TOL / 4
    coarse = _pv_in_bf16(q, k, v, causal, window, split=False)
    assert float((coarse.float() - plain.float()).abs().max()) <= 2e-2
    assert rounding_excess(coarse, exact) > 2 * BF16_EXCESS_TOL


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, k, k)                    # 4 % 3 != 0
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, backend="cuda")    # CPU tensors
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, q, q, backend="triton")
    before = ops.flash_attention.launches
    ops.flash_attention(q, q, q)                        # plain on the CPU
    assert ops.flash_attention.launches == before


def _visible(Sq, Skv, causal, window):
    """The (Sq, Skv) mask of ``mha_reference``, brute force."""
    qpos = np.arange(Sq)[:, None] + Skv - Sq
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (64, 64)])
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (256, 256, True, 0),       # tile-aligned causal
    (200, 200, True, 0),       # S no multiple of the tile
    (64, 700, True, 0),        # end-aligned, Sq < Skv
    (384, 640, True, 0),
    (300, 130, True, 0),       # Sq > Skv: rows that see no key
    (500, 500, True, 30),      # a window shorter than a tile
    (1000, 1000, True, 300),
    (129, 129, False, 0),      # non-causal, ragged end
    (100, 300, False, 50),     # non-causal window, end-aligned
])
def test_tile_plan_matches_a_brute_force_mask(Sq, Skv, causal, window, bq,
                                              bk):
    """The bf16 kernel's plan of K tiles per query tile: a skipped tile
    holds no visible pair, a tile left unmasked only visible pairs (and
    a full one), every other tile of the range is masked, and the range
    is tight (its first and last tiles hold a visible pair)."""
    vis = _visible(Sq, Skv, causal, window)
    plan = ops.tile_plan(Sq, Skv, causal, window, bq, bk)
    assert len(plan) == -(-Sq // bq)
    for qi, (lo, hi, masked) in enumerate(plan):
        rows = vis[qi * bq:(qi + 1) * bq]
        assert 0 <= lo <= hi <= -(-Skv // bk) and len(masked) == hi - lo
        for kt in range(-(-Skv // bk)):
            tile = rows[:, kt * bk:(kt + 1) * bk]
            if not lo <= kt < hi:
                assert not tile.any(), (qi, kt)
            else:
                inside = tile.shape[1] == bk and tile.all()
                assert masked[kt - lo] == (not inside), (qi, kt)
        if lo < hi:
            assert rows[:, lo * bk:(lo + 1) * bk].any()
            assert rows[:, (hi - 1) * bk:hi * bk].any()
        else:
            assert not rows.any()


def _offset_view(shape):
    flat = torch.zeros(1 + int(np.prod(shape)), dtype=torch.bfloat16)
    return flat[1:].view(shape)


@pytest.mark.parametrize("make,want", [
    # one element into its buffer: a base TMA cannot take
    (lambda: _offset_view((1, 4, 130, 32)), False),
    # the model's (B, S, H, D) projection seen as (B, H, S, D)
    (lambda: torch.zeros((2, 64, 4, 128),
                         dtype=torch.bfloat16).transpose(1, 2), True),
    (lambda: torch.zeros((1, 2, 64, 16), dtype=torch.bfloat16), True),
    # a head dim that is not dense
    (lambda: torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)[..., ::2],
     False),
    # rows of 36 elements (72 bytes) holding a head dim of 32
    (lambda: torch.zeros((1, 2, 64, 36), dtype=torch.bfloat16)[..., :32],
     False),
    # rows of 40 (80 bytes): every stride a whole number of 16 bytes
    (lambda: torch.zeros((1, 2, 64, 40), dtype=torch.bfloat16)[..., :32],
     True),
])
def test_tma_compatible(make, want):
    assert ops.tma_compatible(make()) is want
