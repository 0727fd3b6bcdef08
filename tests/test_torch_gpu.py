"""The port's CUDA kernels against their plain PyTorch versions on the
card (bitwise, except decode attention: within 1e-5 in f32 and 2e-2 in
bf16, and flash attention: within 3e-5 in f32 and 2e-2 in bf16, the
tolerances of tests/test_kernels.py, since their sums run in another
order; in bf16 also within ``BF16_EXCESS_TOL`` of the rounding of the
exact value, ``kernels/flash_attention/ref.py::rounding_excess``), and
a pool and a decode server on the card against the same on the CPU,
and one ``train_device`` iteration on the card through the path's
kernels; the flash-attention kernel under autograd (its backward the
plain recompute) and a blocked LM train step on the card against the
CPU; ``train_pipelined`` on two streams against a serial run, the
V-trace update without a host sync, ``train_host_pipelined`` with its
learner on the card; the host engines on the card against the CPU, their launches
per env step, one library build for eight threads, and, with two cards,
every kernel launched for tensors on a card that is not the current
one.  These need a CUDA device: each test is marked ``gpu`` and
skips without one.  Run them on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, and ``--noconftest`` skips tests/conftest.py,
which does: the machine with the card may have no JAX.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.specs import ArraySpec, EnvSpec  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
    load_width,
    resident_rows,
    split_plan,
)
from repro_torch.kernels.env_step.ops import env_multi_step  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BF16_EXCESS_TOL,
    mha_reference,
    rounding_excess,
)
from repro_torch.kernels.image import ops  # noqa: E402
from repro_torch.rl.ppo import PPOConfig, train_device  # noqa: E402
from repro_torch.rl.policy_lm import (  # noqa: E402
    LMPolicy,
    default_policy_config,
)
from repro_torch.serving import DecodePool  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def env_inputs(n, seed, max_cost=10):
    rng = np.random.default_rng(seed)
    state = rng.normal(0, 0.5, (n, 28)).astype(np.float32)
    state[:, 2] = rng.uniform(0.15, 0.9, n)
    return [torch.from_numpy(x).to("cuda") for x in (
        state, rng.uniform(-1.3, 1.3, (n, 8)).astype(np.float32),
        rng.integers(0, max_cost, n).astype(np.int32),
        rng.normal(0, 1, n).astype(np.float32))]


# 1 and 3: a group alone in its warp and block; 1000: a partial block;
# 2048 and 4096: the async and sync Ant cells
@pytest.mark.parametrize("n", [1, 3, 1000, 2048, 4096])
def test_env_step_kernel_is_bitwise(cuda, n):
    args = env_inputs(n, n)
    before = env_multi_step.launches
    for backend_args in (args, args[:2]):
        got = env_multi_step(*backend_args, n_sub=9)
        want = env_multi_step(*backend_args, n_sub=9, backend="reference")
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert env_multi_step.launches == before + 2


@pytest.mark.parametrize("with_cost,with_reward0", [
    (True, True), (True, False), (False, True), (False, False)])
def test_env_step_kernel_costs_and_defaults(cuda, with_cost,
                                            with_reward0):
    """Costs 0..12 at n_sub = 9 (clamped to 9; a 0 leaves the lane bit
    for bit as it was), ``cost=None`` (all lanes n_sub substeps) and
    ``reward0=None`` (from a zero reward)."""
    state, action, cost, reward0 = env_inputs(517, 7, max_cost=13)
    c = cost if with_cost else None
    r0 = reward0 if with_reward0 else None
    got = env_multi_step(state, action, c, r0, n_sub=9)
    want = env_multi_step(state, action, c, r0, n_sub=9,
                          backend="reference")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if with_cost:
        idle = cost == 0
        assert bool(idle.any()) and bool((cost > 9).any())
        assert torch.equal(got[0][idle], state[idle])
        if with_reward0:
            assert torch.equal(got[1][idle], reward0[idle])


def test_env_step_kernel_refuses_a_short_plan(cuda):
    """A launch whose blocks do not cover every lane's group is
    refused."""
    from repro_torch.kernels.build import library
    from repro_torch.kernels.env_step.ops import env_step_plan

    state, action, cost, reward0 = env_inputs(1000, 1)
    out, reward = torch.empty_like(state), torch.empty_like(reward0)
    blocks = env_step_plan(1000)
    ptrs = [x.data_ptr() for x in (state, action, cost, reward0, out,
                                   reward)]
    stream = torch.cuda.current_stream().cuda_stream
    for short in (blocks - 1, 0):
        assert library().env_step_launch(*ptrs, 1000, 9, short,
                                         stream) != 0


@pytest.mark.parametrize("n_sub", [1, 21])
def test_env_step_kernel_at_the_tick_and_skew_depths(cuda, n_sub):
    """4096 lanes at ``n_sub = 1``, masked mode's tick (no costs: every
    lane one substep), and at ``n_sub = 21``, AntSkew-v3's max_cost
    (costs 5..21), bitwise."""
    state, action, _, reward0 = env_inputs(4096, 40 + n_sub)
    cost = None
    if n_sub == 21:
        cost = torch.from_numpy(np.random.default_rng(n_sub).integers(
            5, 22, 4096).astype(np.int32)).to(cuda)
    got = env_multi_step(state, action, cost, reward0, n_sub=n_sub)
    want = env_multi_step(state, action, cost, reward0, n_sub=n_sub,
                          backend="reference")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def run_pool(task, dev, m, engine="device", schedule="fifo", recvs=12,
             **kw):
    """A pool's served (ids, done, cost, reward, obs) on ``dev``, its
    ``stats()`` and the env_step launches it made, from seeded actions
    routed by env_id."""
    pool = repro_torch.make(task, num_envs=16, batch_size=m, engine=engine,
                            schedule=schedule, device=dev,
                            max_episode_steps=5, **kw)
    table = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (recvs, 16, 8)).astype(np.float32))
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    before = env_multi_step.launches
    rec = []
    for t in range(recvs):
        ps, ts = pool.step(ps, table[t][ts.env_id.long().cpu()].to(dev),
                           ts.env_id)
        rec.append([getattr(ts, k).cpu() for k in (
            "env_id", "done", "step_cost", "reward", "obs")])
    return rec, pool.stats(ps), env_multi_step.launches - before


@pytest.mark.parametrize("task,m,engine,schedule,atol", [
    ("Ant-v3", 8, "device-masked", "fifo", 1e-4),
    ("AntSkew-v3", 8, "device", "sjf", 1e-4),
    ("AntNorm-v3", None, "device", "fifo", 1e-3),
])
def test_ant_pools_on_the_card_match_the_cpu(cuda, task, m, engine,
                                             schedule, atol):
    """Discrete fields and ``stats()`` bitwise; floats within 1e-4 (CUDA's
    ``cosf`` against torch's CPU ``cos``), AntNorm's normalized obs within
    1e-3 (its block sums run in another order)."""
    got, gstats, launches = run_pool(task, cuda, m, engine, schedule)
    want, cstats, _ = run_pool(task, "cpu", m, engine, schedule)
    assert launches > 0
    for t, (g, c) in enumerate(zip(got, want)):
        for x, y in zip(g[:3], c[:3]):
            assert torch.equal(x, y), t
        for x, y in zip(g[3:], c[3:]):
            assert torch.allclose(x, y, rtol=0, atol=atol), t
    assert gstats.keys() == cstats.keys()
    for k, v in cstats.items():
        assert np.array_equal(gstats[k], v), k


@pytest.mark.parametrize("task,m,schedule,shards,atol", [
    ("Ant-v3", None, "fifo", 4, 1e-4),
    ("AntSkew-v3", 8, "hierarchical", 4, 1e-4),
    ("AntNorm-v3", 8, "hierarchical", 2, 1e-3),
])
def test_sharded_pools_on_the_card_match_the_cpu(cuda, task, m, schedule,
                                                 shards, atol):
    """The sharded engine on the card against the CPU, as above; every
    recv steps all local shards' rows in one env_step launch."""
    got, gstats, launches = run_pool(task, cuda, m, "device-sharded",
                                     schedule, num_shards=shards)
    want, cstats, _ = run_pool(task, "cpu", m, "device-sharded", schedule,
                               num_shards=shards)
    assert launches == 12
    for t, (g, c) in enumerate(zip(got, want)):
        for x, y in zip(g[:3], c[:3]):
            assert torch.equal(x, y), t
        for x, y in zip(g[3:], c[3:]):
            assert torch.allclose(x, y, rtol=0, atol=atol), t
    for k, v in cstats.items():
        assert np.array_equal(gstats[k], v), k


def test_masked_recv_on_the_card_launches_env_step(cuda):
    """No plain fallback hides the kernel: a masked recv that ticks
    launches env_step, once a tick."""
    pool = repro_torch.make("Ant-v3", 64, 32, engine="device-masked",
                            device=cuda)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(1))
    act = torch.zeros((32, 8), device=cuda)
    ps, ts = pool.step(ps, act, ts.env_id)      # the reset's READY half
    before, ticks = env_multi_step.launches, pool.masked_ticks
    ps, ts = pool.step(ps, act, ts.env_id)
    assert pool.masked_ticks > ticks
    assert env_multi_step.launches - before == pool.masked_ticks - ticks


def test_image_kernels_are_bitwise(cuda):
    rng = np.random.default_rng(1)
    pos = [torch.from_numpy(p).to(cuda) for p in
           rng.uniform(0, 84, (4, 33)).astype(np.float32)]
    rgb = ops.pong_render(*pos)
    assert torch.equal(rgb, ops.pong_render(*pos, backend="reference"))
    gray = ops.grayscale(rgb)
    assert torch.equal(gray, ops.grayscale(rgb, backend="reference"))
    for oh, ow, method in ((84, 84, "area"), (50, 31, "bilinear")):
        assert torch.equal(ops.resize(gray, oh, ow, method),
                           ops.resize(gray, oh, ow, method,
                                      backend="reference"))


def test_kernels_launch_on_their_tensors_card(cuda):
    """With card 0 current, inputs on the last card launch there (the
    launch switches to the tensor's card; each entry point launches onto
    the current one): env_step, the image kernels, decode and flash
    attention agree with their plain versions on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = torch.device(f"cuda:{torch.cuda.device_count() - 1}")
    torch.cuda.set_device(0)
    args = [x.to(last) for x in env_inputs(64, 3)]
    for g, w in zip(env_multi_step(*args, n_sub=9),
                    env_multi_step(*args, n_sub=9, backend="reference")):
        assert g.device == last and torch.equal(g, w)
    rng = np.random.default_rng(2)
    pos = [torch.from_numpy(p).to(last) for p in
           rng.uniform(0, 84, (4, 9)).astype(np.float32)]
    rgb = ops.pong_render(*pos)
    assert torch.equal(rgb, ops.pong_render(*pos, backend="reference"))
    gray = ops.grayscale(rgb)
    assert torch.equal(gray, ops.grayscale(rgb, backend="reference"))
    assert torch.equal(ops.resize(gray, 84, 84),
                       ops.resize(gray, 84, 84, backend="reference"))
    assert torch.equal(ops.crop(gray, 34, 0, 160, 160),
                       ops.crop(gray, 34, 0, 160, 160, backend="reference"))
    gen = torch.Generator(device=last).manual_seed(0)
    q = torch.randn((2, 4, 64), generator=gen, device=last)
    k = torch.randn((2, 2, 40, 64), generator=gen, device=last)
    v = torch.randn((2, 2, 40, 64), generator=gen, device=last)
    lengths = torch.tensor([17, 40], dtype=torch.int32, device=last)
    torch.testing.assert_close(
        decode_attention(q, k, v, lengths),
        decode_attention(q, k, v, lengths, backend="reference"),
        atol=1e-5, rtol=0)
    qf = torch.randn((1, 2, 48, 64), generator=gen, device=last)
    torch.testing.assert_close(
        flash_attention(qf, qf, qf, causal=True),
        flash_attention(qf, qf, qf, causal=True, backend="reference"),
        atol=3e-5, rtol=0)
    assert torch.cuda.current_device() == 0


# (ball_x, ball_y, paddle_y, enemy_y) on the 84-grid: the ball at the
# edges and beyond them, on each paddle (priority), the paddles at the
# top and bottom edges, whole and half grid values
RENDER_CASES = [
    (0.0, 0.0, 42.0, 42.0), (84.0, 84.0, 42.0, 42.0),
    (-3.0, 90.0, 0.0, 84.0), (90.0, -3.0, 84.0, 0.0),
    (82.5, 40.0, 40.0, 10.0),     # on the player's paddle
    (83.0, 6.0, 6.5, 70.0),
    (1.0, 20.0, 60.0, 20.0),      # on the enemy's paddle
    (1.5, 77.5, 12.0, 77.0),
    (40.5, 41.0, 0.5, 83.5), (20.0, 62.5, 83.5, 0.5),
    (42.0, 42.0, -6.0, 90.0),
]


def render_inputs(n, seed):
    """``n`` lanes: the edge cases first, then random positions, a
    half of them on the half grid."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 84, (4, n)).astype(np.float32)
    pos[:, ::2] = np.round(pos[:, ::2] * 2) / 2
    k = min(n, len(RENDER_CASES))
    pos[:, :k] = np.array(RENDER_CASES[:k], np.float32).T
    return pos


@pytest.mark.parametrize("n", [1, 5, 33, 1024])
def test_pong_render_kernel_is_bitwise(cuda, n):
    pos = [torch.from_numpy(p).to(cuda) for p in render_inputs(n, n)]
    before = ops.pong_render.launches
    got = ops.pong_render(*pos)
    assert ops.pong_render.launches == before + 1
    assert got.shape == (n, 210, 160, 3)
    assert torch.equal(got, ops.pong_render(*pos, backend="reference"))
    assert torch.equal(got, ops.pong_render(*pos))      # repeated


@pytest.mark.parametrize("case", RENDER_CASES)
def test_pong_render_edge_cases_alone(cuda, case):
    pos = [torch.tensor([v], dtype=torch.float32, device=cuda) for v in case]
    assert torch.equal(ops.pong_render(*pos),
                       ops.pong_render(*pos, backend="reference"))


@pytest.mark.parametrize("shape", [
    (1, 210, 160, 3), (1024, 210, 160, 3),
    (2, 3, 210, 160, 3),          # leading batch dims
    (3, 7, 5, 3),                 # 105 pixels: the byte path
])
def test_grayscale_kernel_is_bitwise(cuda, shape):
    rgb = torch.from_numpy(np.random.default_rng(len(shape)).integers(
        0, 256, shape, np.uint8)).to(cuda)
    if rgb.numel() >= 256 * 3:
        assert len(torch.unique(rgb)) == 256
    before = ops.grayscale.launches
    got = ops.grayscale(rgb)
    assert ops.grayscale.launches == before + 1
    assert got.shape == shape[:-1]
    assert torch.equal(got, ops.grayscale(rgb, backend="reference"))
    assert torch.equal(got, ops.grayscale(rgb))          # repeated


def test_grayscale_kernel_unaligned_batch(cuda):
    """A batch one byte into its buffer takes the byte path."""
    flat = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, 1 + 3 * 210 * 160 * 3, np.uint8)).to(cuda)
    rgb = flat[1:].view(3, 210, 160, 3)
    assert not ops.vector_pixels(rgb.data_ptr(), 0, 3 * 210 * 160)
    assert torch.equal(ops.grayscale(rgb),
                       ops.grayscale(rgb, backend="reference"))


def test_pong_pool_on_the_card_matches_the_cpu(cuda):
    out = {}
    for dev in (cuda, "cpu"):
        pool = repro_torch.make("PongClassic-v5", num_envs=8, batch_size=4,
                                device=dev, max_episode_steps=5)
        ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
        rec = []
        for t in range(12):
            a = (ts.env_id.cpu() * 7 + t) % 6
            ps, ts = pool.step(ps, a.to(dev), ts.env_id)
            rec.append((ts.env_id.cpu(), ts.reward.cpu(), ts.obs.cpu()))
        out[str(dev)] = rec
    for g, c in zip(out["cuda"], out["cpu"]):
        for x, y in zip(g, c):
            assert torch.equal(x, y)


# one window per path of ops.crop_plan on 210 x 160 images
CROP_WINDOWS = [
    ((34, 0, 160, 160), ops.CROP_RUNS),       # the Pong playfield
    ((3, 16, 101, 32), ops.CROP_SPANS),
    ((3, 4, 101, 36), ops.CROP_WORDS),
    ((3, 5, 101, 37), ops.CROP_BYTES),
]


@pytest.mark.parametrize("window,path", CROP_WINDOWS)
@pytest.mark.parametrize("n", [0, 1, 9, 1024])
def test_crop_kernel_is_bitwise(cuda, n, window, path):
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (n, 210, 160), np.uint8)).to(cuda)
    before = ops.crop.launches
    got = ops.crop(img, *window)
    assert ops.crop.launches == before + 1
    assert ops.crop_plan(img.data_ptr(), got.data_ptr(), 210, 160,
                         *window) == path
    assert torch.equal(got, ops.crop(img, *window, backend="reference"))


@pytest.mark.parametrize("window,path", CROP_WINDOWS)
def test_crop_kernel_unaligned_batch(cuda, window, path):
    """A batch one byte into its buffer takes the byte path on every
    window; odd n, with leading dims."""
    flat = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, 1 + 15 * 210 * 160, np.uint8)).to(cuda)
    img = flat[1:].view(3, 5, 210, 160)
    assert img.storage_offset() == 1
    assert ops.crop_plan(img.data_ptr(), 0, 210, 160,
                         *window) == ops.CROP_BYTES
    assert torch.equal(ops.crop(img, *window),
                       ops.crop(img, *window, backend="reference"))


def test_crop_kernel_refuses_a_false_plan(cuda):
    """The C entry point checks the plan's alignment claim again: a
    claim that a pointer lacks is an error, not a quiet fallback."""
    from repro_torch.kernels.build import library

    flat = torch.zeros(1 + 2 * 210 * 160, dtype=torch.uint8, device=cuda)
    out = torch.empty((2, 160, 160), dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for path in (ops.CROP_RUNS, ops.CROP_SPANS, ops.CROP_WORDS):
        assert library().crop_launch(flat.data_ptr() + 1, out.data_ptr(),
                                     2, 210, 160, 34, 0, 160, 160, path,
                                     stream) != 0


@pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (8, 8, 64), (16, 1, 16),
                                     (12, 4, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(cuda, H, Hkv, D, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(H + D)
    B, L, T = 7, 3, 97
    cache = torch.from_numpy(rng.normal(0, 1, (2, B, L, Hkv, T, D)).astype(
        np.float32)).to(cuda, dtype)
    k, v = cache[0][:, 1], cache[1][:, 1]      # strided layer views
    q = torch.from_numpy(rng.normal(0, 1, (B, H, D)).astype(
        np.float32)).to(cuda, dtype)
    lengths = torch.tensor([0, 1, T, 2, 50, 96, 5], dtype=torch.int32,
                           device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths)
    assert decode_attention.launches == before + 1
    want = decode_attention(q, k, v, lengths, backend="reference")
    assert got.dtype == dtype and torch.all(got[0] == 0)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=0, atol=atol)


def _decode_case(cuda, B, H, Hkv, T, D, dtype, L=3, seed=0):
    """q and strided layer-1 views of a (B, L, Hkv, T, D) cache, lengths
    with 0, 1 and T."""
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.normal(0, 1, (2, B, L, Hkv, T, D)).astype(
        np.float32)).to(cuda, dtype)
    q = torch.from_numpy(rng.normal(0, 1, (B, H, D)).astype(
        np.float32)).to(cuda, dtype)
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, T)
    return q, cache[0][:, 1], cache[1][:, 1], torch.from_numpy(lengths).to(
        cuda)


def _check_decode(q, k, v, lengths):
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths)
    assert decode_attention.launches == before + 1
    want = decode_attention(q, k, v, lengths, backend="reference")
    assert got.dtype == q.dtype and torch.all(got[lengths == 0] == 0)
    atol = 1e-5 if q.dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=0, atol=atol)
    return got


@pytest.mark.parametrize("B,T", [(32, 161), (128, 64)])  # serve, collect
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_main_path_shapes(cuda, B, T, dtype):
    """qwen3-0.6b heads at the serve cell's (32 lanes, cache 161) and the
    LM collect's (128 lanes, cache 64) shapes, with 16-byte copies."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, lengths = _decode_case(cuda, B, 16, 8, T, 128, dtype, seed=T)
    assert load_width(k, v) == 16
    _check_decode(q, k, v, lengths)


@pytest.mark.parametrize("T,chunks", [(1000, 8), (5000, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_long_caches(cuda, T, chunks, dtype):
    """Caches far longer than any caller's: each of the block's 8 warps
    takes up to ``chunks`` chunks of 16 positions in turn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, lengths = _decode_case(cuda, 5, 8, 2, T, 64, dtype, seed=5)
    props = torch.cuda.get_device_properties(cuda)
    resident = resident_rows(props.multi_processor_count,
                             props.shared_memory_per_multiprocessor,
                             64 * q.element_size())
    warps, rows = split_plan(5, 2, T, resident)
    assert (warps, rows) == (8, 16) and -(-T // (warps * rows)) == chunks
    _check_decode(q, k, v, lengths)


@pytest.mark.parametrize("D,offset,width", [
    (20, 0, 8),      # a 40-byte bf16 row
    (64, 1, 2),      # a view one element into its buffer
])
def test_decode_attention_narrow_loads(cuda, D, offset, width):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(D)
    B, H, Hkv, T = 6, 6, 3, 70
    shape = (B, Hkv, T, D)

    def view(shape):
        flat = torch.from_numpy(rng.normal(0, 1, offset + int(np.prod(
            shape))).astype(np.float32)).to(cuda, torch.bfloat16)
        return flat[offset:].view(shape)

    q, k, v = view((B, H, D)), view(shape), view(shape)
    lengths = torch.tensor([0, 1, T, 33, 64, 9], dtype=torch.int32,
                           device=cuda)
    assert load_width(k, v) == width
    _check_decode(q, k, v, lengths)


def test_decode_attention_is_deterministic(cuda):
    q, k, v, lengths = _decode_case(cuda, 32, 16, 8, 161, 128,
                                    torch.bfloat16, seed=1)
    first = decode_attention(q, k, v, lengths)
    for _ in range(5):
        assert torch.equal(decode_attention(q, k, v, lengths), first)


@pytest.mark.parametrize("shape,out,method", [
    ((1, 210, 160), (84, 84), "area"),
    ((5, 210, 160), (84, 84), "area"),
    ((1024, 210, 160), (84, 84), "area"),     # the PongClassic sync block
    ((2, 3, 210, 160), (84, 84), "area"),     # leading batch dims
    ((1024, 160, 160), (84, 84), "area"),     # the cropped playfield
    ((7, 210, 160), (84, 84), "bilinear"),
    ((9, 37, 29), (11, 17), "area"),          # no bulk copy, byte columns
    ((9, 37, 29), (11, 17), "bilinear"),
])
def test_resize_kernel_shapes(cuda, shape, out, method):
    torch.backends.cuda.matmul.allow_tf32 = False
    img = torch.from_numpy(np.random.default_rng(len(shape)).integers(
        0, 256, shape, np.uint8)).to(cuda)
    before = ops.resize.launches
    got = ops.resize(img, *out, method)
    assert ops.resize.launches == before + 1
    assert got.shape == shape[:-2] + out
    assert torch.equal(got, ops.resize(img, *out, method,
                                       backend="reference"))


def test_resize_kernel_unaligned_image(cuda):
    """A batch one byte into its buffer takes the byte copy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, 1 + 3 * 210 * 160, np.uint8)).to(cuda)
    img = flat[1:].view(3, 210, 160)
    assert not ops.bulk_copies(img.data_ptr(), 210, 160)
    assert torch.equal(ops.resize(img, 84, 84),
                       ops.resize(img, 84, 84, backend="reference"))


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window,dtype", [
    # causal GQA in bf16, a length that is no multiple of the tile
    (2, 8, 2, 200, 200, 128, True, 0, torch.bfloat16),
    # sliding window in f32, queries end-aligned against a longer key set
    (1, 4, 1, 100, 301, 64, True, 37, torch.float32),
    # non-causal, D = 16 and D = 32
    (1, 2, 2, 70, 70, 16, False, 0, torch.float32),
    (2, 6, 3, 65, 129, 32, False, 0, torch.bfloat16),
    # the tensor-core path with a window, end-aligned; D = 16
    (1, 4, 2, 150, 333, 64, True, 45, torch.bfloat16),
    (2, 4, 4, 64, 64, 16, True, 0, torch.bfloat16),
    # the K/V ring wraps many times and every mask class occurs at the
    # bf16 kernel's 128 x 128 tiles: skipped, unmasked, diagonal, window
    # edge, ragged end; end-aligned Sq < Skv; non-causal with a ragged end
    (1, 8, 2, 1000, 1000, 128, True, 300, torch.bfloat16),
    (2, 4, 1, 384, 640, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 129, 129, 32, False, 0, torch.bfloat16),
    # hymba-1.5b's layout: 25 query heads over 5 kv heads (a GQA group
    # of 5), D = 64, its 1024-token window, bf16
    (2, 25, 5, 1300, 1300, 64, True, 1024, torch.bfloat16),
])
def test_flash_attention_kernel(cuda, B, H, Hkv, Sq, Skv, D, causal, window,
                                dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + D)
    # q and k as (B, S, H, D) projections seen as (B, H, S, D) views
    q = torch.from_numpy(rng.normal(0, 1, (B, Sq, H, D)).astype(
        np.float32)).to(cuda, dtype).transpose(1, 2)
    k, v = (torch.from_numpy(rng.normal(0, 1, (B, Skv, Hkv, D)).astype(
        np.float32)).to(cuda, dtype).transpose(1, 2) for _ in range(2))
    before, copies = flash_attention.launches, flash_attention.copies
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    assert flash_attention.copies == copies      # aligned views: no copy
    want = flash_attention(q, k, v, causal=causal, window=window,
                           backend="reference")
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert got.transpose(1, 2).is_contiguous()     # q's layout, no copy
    _check_flash(got, want, q, k, v, causal=causal, window=window)


def _check_flash(got, want, q, k, v, **masks):
    """Within 3e-5 (f32) or 2e-2 (bf16) of the plain version; in bf16
    also within ``BF16_EXCESS_TOL`` of the rounding of the exact value."""
    atol = 3e-5 if got.dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=0, atol=atol)
    if got.dtype == torch.bfloat16:
        exact = mha_reference(q.float(), k.float(), v.float(), **masks)
        assert rounding_excess(got, exact) <= BF16_EXCESS_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_inputs(cuda, dtype):
    """Views that start one element into their buffer.  TMA cannot load
    them, so in bf16 the wrapper copies each of q, k and v into a fresh
    dense tensor first; the f32 kernel reads them as they lie."""
    rng = np.random.default_rng(11)
    B, H, S, D = 1, 4, 130, 32

    def view(shape):
        flat = torch.from_numpy(rng.normal(0, 1, 1 + int(np.prod(shape)))
                                .astype(np.float32)).to(cuda, dtype)
        return flat[1:].view(shape)

    q, k, v = view((B, H, S, D)), view((B, 2, S, D)), view((B, 2, S, D))
    before, copies = flash_attention.launches, flash_attention.copies
    got = flash_attention(q, k, v, window=20)
    assert flash_attention.launches == before + 1
    assert flash_attention.copies == copies + (
        3 if dtype == torch.bfloat16 else 0)
    want = flash_attention(q, k, v, window=20, backend="reference")
    _check_flash(got, want, q, k, v, window=20)


def test_flash_attention_row_without_keys_is_zero(cuda):
    q = torch.ones((1, 2, 96, 32), device=cuda)
    k = torch.ones((1, 2, 40, 32), device=cuda)
    out = flash_attention(q, k, k)                  # causal, Sq > Skv
    assert torch.all(out[:, :, :56] == 0)
    assert torch.allclose(out[:, :, 56:], torch.ones_like(out[:, :, 56:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_without_keys_is_zero(cuda, dtype):
    """Skv = 0: every row sees no key and gives 0."""
    q = torch.ones((1, 2, 70, 64), device=cuda, dtype=dtype)
    k = torch.ones((1, 1, 0, 64), device=cuda, dtype=dtype)
    for causal in (True, False):
        out = flash_attention(q, k, k, causal=causal)
        assert out.shape == q.shape and torch.all(out == 0)


# (B, H, Hkv, S, D, causal, window, dtype, chunks): the train step's
# calls (qwen3-0.6b's heads at a short S), the same with the plain
# backward in 4 chunks of query rows, a sliding layer, GQA 4, f32
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,dtype,chunks", [
    (2, 16, 8, 256, 128, True, 0, torch.bfloat16, 1),
    (2, 16, 8, 256, 128, True, 0, torch.bfloat16, 4),
    (2, 16, 8, 256, 128, True, 0, torch.float32, 1),
    (1, 8, 2, 300, 64, True, 64, torch.bfloat16, 1),
    (1, 4, 1, 130, 32, True, 37, torch.float32, 1),
])
def test_flash_attention_gradient(cuda, monkeypatch, B, H, Hkv, S, D,
                                  causal, window, dtype, chunks):
    """Under autograd the kernel's output has a ``grad_fn``, the forward
    launches the kernel once and the backward does not launch it; the
    output is the kernel's (within 2e-2 and ``BF16_EXCESS_TOL`` of the
    rounding of the exact value in bf16, 3e-5 in f32, of
    ``mha_reference``), and dq, dk and dv are those of unchunked
    autograd through ``mha_reference`` (within 2e-2 in bf16 and 1e-5 in
    f32, relative to each gradient's largest entry).  The backward never
    reads the kernel's output, so the gradients check the wiring and
    the output checks the kernel."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    monkeypatch.setattr(flash_ops, "BACKWARD_SCORE_BYTES",
                        4 * B * H * S * -(-S // chunks))
    assert -(-S // flash_ops.chunk_rows(B, H, S, S, causal)) == chunks
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S + D)

    def view(h):
        return torch.from_numpy(rng.normal(0, 1, (B, S, h, D)).astype(
            np.float32)).to(cuda, dtype).transpose(1, 2).requires_grad_()

    q, k, v = view(H), view(Hkv), view(Hkv)
    dout = torch.from_numpy(rng.normal(0, 1, (B, H, S, D)).astype(
        np.float32)).to(cuda, dtype)
    masks = dict(causal=causal, window=window)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **masks)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert flash_attention.launches == before + 1
    with torch.no_grad():
        fwd_err = float((out.float() - mha_reference(
            q, k, v, **masks).float()).abs().max())
        if dtype == torch.bfloat16:
            assert fwd_err <= 2e-2
            assert rounding_excess(out, mha_reference(
                q.float(), k.float(), v.float(),
                **masks)) <= BF16_EXCESS_TOL
        else:
            assert fwd_err <= 3e-5
    want = torch.autograd.grad(mha_reference(q, k, v, **masks), (q, k, v),
                               dout)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype
        assert torch.isfinite(g).all()
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


def test_flash_attention_without_grad_is_the_plain_launch(cuda):
    q = torch.randn((1, 4, 64, 32), device=cuda, requires_grad=True)
    k = torch.randn((1, 2, 64, 32), device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        assert flash_attention(q, k, k).grad_fn is None
    assert flash_attention(q.detach(), k, k).grad_fn is None
    assert flash_attention.launches == before + 2
    out = flash_attention(q, k, k)
    assert out.grad_fn is not None and flash_attention.launches == before + 3
    (out.float().sum()).backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert flash_attention.launches == before + 3


def test_blocked_train_step_on_the_card_matches_the_cpu(cuda):
    """Three train steps of the f32 smoke qwen3 with the blocked branch
    at the default ``remat="full"``: losses within 1e-5 of the CPU's,
    two flash launches per layer a step (the forward's and the
    recompute's in the backward)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import BatchSpec, SyntheticSource
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3-0.6b").replace(compute_dtype=torch.float32,
                                                 attn_impl="blocked")
    opt = adamw(weight_decay=0.01)
    start = init_train_state(build_model(cfg, "cpu"), opt,
                             torch.Generator().manual_seed(0))
    src = SyntheticSource(cfg.vocab, branching=8, seed=1)
    losses = {}
    for dev in ("cuda", "cpu"):
        step = make_train_step(build_model(cfg, dev), opt,
                               linear_warmup_cosine(1e-2, 1, 3))
        state = tree_map(lambda x: x.to(dev), start)
        before = flash_attention.launches
        losses[dev] = []
        for t in range(3):
            batch = src.batch(BatchSpec(4, 64, cfg.vocab), t)
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in batch.items()})
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            assert cfg.remat == "full"
            assert flash_attention.launches - before == 3 * 2 * cfg.n_layers
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-large-v3",
                                  "qwen2-vl-72b"])
def test_family_forward_on_the_card_matches_the_cpu(cuda, arch):
    """The f32 smoke xLSTM, Whisper and vlm (blocked: one flash launch a
    layer, patch embeddings before the tokens, M-RoPE positions):
    ``Model.prefill`` and 4 greedy ``decode_step``s on the card against
    the CPU (identical tokens, logits within 1e-4) and ``train_loss``
    (within 1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import synth_batch
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(compute_dtype=torch.float32,
                                         attn_impl="blocked")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    S = 16
    batch = synth_batch(build_model(cfg, "cpu"),
                        ShapeSpec("p", "prefill", S, 2),
                        torch.Generator().manual_seed(1))
    train = synth_batch(build_model(cfg, "cpu"),
                        ShapeSpec("t", "train", S, 2),
                        torch.Generator().manual_seed(2))
    if cfg.family == "vlm":
        batch["patch_embeds"] = train["patch_embeds"]
        batch["tokens"] = batch["tokens"][:, 4:]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        p = tree_map(lambda x: x.to(dev), params)
        before = flash_attention.launches
        logits, cache = model.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, max_len=S + 4)
        if dev == "cuda" and cfg.family == "vlm":
            assert flash_attention.launches - before == 0  # S < max_len
        toks, logs = [], [logits.cpu()]
        for t in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            toks.append(nxt.cpu())
            pos = (torch.full((2, 1, 3), S + t, device=dev)
                   if cfg.family == "vlm" else None)
            logits, cache = model.decode_step(p, nxt[:, None], cache,
                                              positions=pos)
            logs.append(logits.cpu())
        loss, _ = model.train_loss(p, {k: v.to(dev)
                                       for k, v in train.items()})
        runs[dev] = (torch.stack(toks), torch.stack(logs), float(loss))
        if cfg.family == "vlm":
            before = flash_attention.launches
            model.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                          max_len=S)
            if dev == "cuda":
                assert flash_attention.launches - before == cfg.n_layers
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], rtol=1e-4,
                               atol=1e-4)
    assert abs(runs["cuda"][2] - runs["cpu"][2]) <= 1e-5


def test_decode_pool_on_the_card_matches_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = EnvSpec("serve", ArraySpec((2,), torch.int32, 0, 63),
                   ArraySpec((), torch.int32, 0, 63))
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, 64, rng.integers(2, 7)))
               for _ in range(6)]
    cfg = default_policy_config(64, 15)
    params = LMPolicy(spec, cfg, max_len=15, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pol = LMPolicy(spec, cfg, max_len=15, device=dev)
        out[dev.type] = DecodePool(pol, 3, 8).serve(_to(params, dev),
                                                    prompts)[0]
    assert out["cuda"] == out["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("task,kernels", [
    ("Ant-v3", (env_multi_step,)),
    ("PongClassic-v5", (ops.pong_render, ops.grayscale, ops.resize)),
])
def test_train_device_runs_on_the_card_through_the_kernels(cuda, task,
                                                           kernels):
    """One small ``train_device`` iteration on a pool made without a
    device: it runs on the card, and the path's kernels launch."""
    before = [k.launches for k in kernels]
    pool = repro_torch.make(task, num_envs=8, max_episode_steps=5)
    state, _, history = train_device(
        pool, PPOConfig(total_steps=8 * 8, num_steps=8), seed=0,
        hidden=(32, 32))
    assert len(history) == 1 and history[0]["episodes"] > 0
    assert all(np.isfinite(history[0][k]) for k in ("loss", "pg", "vf"))
    for leaf in tree_leaves(state.params):
        assert leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all())
    for k, n in zip(kernels, before):
        assert k.launches > n, k.__name__


@pytest.mark.parametrize("task,n", [("Ant-v3", 512), ("PongClassic-v5", 64)])
def test_train_pipelined_on_two_streams_matches_a_serial_run(cuda, task, n,
                                                             monkeypatch):
    """``train_pipelined`` with its update on a second stream against the
    same run with ``torch.cuda.synchronize()`` before each half: the same
    history and params, bitwise (cuDNN deterministic), so no tensor that
    crosses the streams was handed out again while the other stream read
    it."""
    from repro_torch.rl import ppo

    class Serial(ppo._Streams):
        def to_update(self, *trees):
            torch.cuda.synchronize()
            super().to_update(*trees)

        def to_collect(self, event, params):
            torch.cuda.synchronize()
            super().to_collect(event, params)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = PPOConfig(total_steps=3 * 16 * n, num_steps=16)
    runs = []
    for streams in (ppo._Streams, Serial):
        monkeypatch.setattr(ppo, "_Streams", streams)
        pool = repro_torch.make(task, num_envs=n, max_episode_steps=20)
        state, _, history = ppo.train_pipelined(pool, cfg, seed=1)
        runs.append((history, tree_leaves(state.params)))
    (h_pipe, p_pipe), (h_serial, p_serial) = runs
    assert len(h_pipe) == 3
    for a, b in zip(h_pipe, h_serial):
        assert {k: v for k, v in a.items() if k != "time_s"} == {
            k: v for k, v in b.items() if k != "time_s"}
    for a, b in zip(p_pipe, p_serial):
        assert torch.equal(a, b)


@pytest.mark.parametrize("task", ["Ant-v3", "PongClassic-v5"])
def test_vtrace_update_issues_no_host_sync(cuda, task):
    """The pipelined learner's update, recompute and V-trace included,
    queues its work without waiting for the card
    (``torch.cuda.set_sync_debug_mode("error")`` raises on a sync): the
    host is free to dispatch the collect behind it."""
    from repro_torch.rl.nets import ActorCritic
    from repro_torch.rl.ppo import PPOState, make_vtrace_ppo_update

    pool = repro_torch.make(task, num_envs=16)
    net = ActorCritic(pool.spec, (32, 32))
    cfg = PPOConfig(num_steps=8, epochs=2, minibatches=2)
    opt, update = make_vtrace_ppo_update(net, cfg, 8)
    params = net.init(repro_torch.random.PRNGKey(0, device=cuda))
    state = PPOState(params, opt.init(params),
                     torch.zeros((), dtype=torch.int32, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(0)
    obs_shape = (8, 16) + pool.spec.obs_spec.shape
    obs = (torch.randint(0, 256, obs_shape, generator=gen, device=cuda)
           .to(torch.uint8) if pool.spec.obs_spec.dtype == torch.uint8
           else torch.randn(obs_shape, generator=gen, device=cuda))
    actions = (torch.randint(0, net.act_dim, (8, 16), generator=gen,
                             device=cuda).to(torch.int32) if net.discrete
               else torch.randn((8, 16, net.act_dim), generator=gen,
                                device=cuda))
    traj = {"obs": obs, "actions": actions,
            "logp": torch.randn((8, 16), generator=gen, device=cuda) - 2,
            "rewards": torch.randn((8, 16), generator=gen, device=cuda),
            "dones": torch.rand((8, 16), generator=gen, device=cuda) < 0.2,
            "last_obs": obs[-1]}
    key = repro_torch.random.PRNGKey(1, device=cuda)
    update(state, traj, key)    # warm: cuBLAS and cuDNN set up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = update(state, traj, key)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["rho_behavior"]))


def test_train_host_pipelined_learner_on_the_card(cuda):
    """Envs on the CPU (thread engine), the learner on the card: two
    iterations, finite metrics, the three buckets."""
    from repro_torch.rl.ppo import train_host_pipelined

    pool = repro_torch.make("Ant-v3", num_envs=8, engine="thread",
                            num_threads=2, device="cpu")
    try:
        state, _, history, prof = train_host_pipelined(
            pool, cfg=PPOConfig(total_steps=2 * 8 * 8, num_steps=8,
                                epochs=1, minibatches=2), hidden=(32, 32))
    finally:
        pool.close()
    assert len(history) == 2 and set(prof) == {"actor_wait", "train",
                                                "other"}
    assert all(np.isfinite(r[k]) for r in history for k in (
        "loss", "rho_behavior"))
    for leaf in tree_leaves(state.params):
        assert leaf.device.type == "cuda"


def run_host_pool(task, dev, engine, n=8, steps=10):
    """A host pool's blocks on ``dev``, rows in ``env_id`` order (ids,
    done, cost, reward, obs on the CPU), its ``stats()`` and the launches
    of the Ant and Pong kernels over its steps (the reset excluded), a
    subprocess pool's read from its workers."""
    pool = repro_torch.make(task, num_envs=n, engine=engine, num_threads=4,
                            device=dev, max_episode_steps=5)
    act = pool.spec.act_spec
    rng = np.random.default_rng(5)
    kernels = (env_multi_step, ops.pong_render, ops.grayscale, ops.resize)
    names = ("env_step", "pong_render", "grayscale", "resize")

    def counts():
        workers = pool.launches() if engine == "subprocess" else {}
        return [k.launches + workers.get(name, 0)
                for k, name in zip(kernels, names)]

    try:
        out = pool.reset()
        before = counts()
        rec = []
        for _ in range(steps):
            ids = out["env_id"].cpu().numpy()
            a = (rng.uniform(-1, 1, (n,) + act.shape).astype(np.float32)
                 if act.dtype.is_floating_point
                 else rng.integers(0, 6, n).astype(np.int32))
            out = pool.step(torch.from_numpy(a[ids]).to(dev), out["env_id"])
            assert out["obs"].device.type == torch.device(dev).type
            order = out["env_id"].cpu().argsort()
            rec.append([out[k].cpu()[order] for k in (
                "env_id", "done", "step_cost", "reward", "obs")])
        stats = pool.stats()
        launches = [c - b for c, b in zip(counts(), before)]
    finally:
        pool.close()
    return rec, stats, launches


@pytest.mark.parametrize("task,engine,atol", [
    ("Ant-v3", "thread", 1e-4), ("Ant-v3", "forloop", 1e-4),
    ("Ant-v3", "subprocess", 1e-4), ("PongClassic-v5", "thread", None),
])
def test_host_pools_on_the_card_match_the_cpu(cuda, task, engine, atol):
    """The host engines on the card (envs stepped there, one lane each,
    the block transformed there) against the same on the CPU: ids, done,
    cost and ``stats()`` bitwise; Pong's obs and reward bitwise, Ant's
    within 1e-4 (CUDA's ``cosf`` against torch's CPU ``cos``)."""
    got, gstats, _ = run_host_pool(task, cuda, engine)
    want, cstats, _ = run_host_pool(task, "cpu", engine)
    for t, (g, c) in enumerate(zip(got, want)):
        for x, y in zip(g[:3], c[:3]):
            assert torch.equal(x, y), t
        for x, y in zip(g[3:], c[3:]):
            assert (torch.equal(x, y) if atol is None else
                    torch.allclose(x, y, rtol=0, atol=atol)), t
    for k, v in cstats.items():
        assert np.array_equal(gstats[k], v), k


@pytest.mark.parametrize("task,engine,n,per_step,per_recv", [
    ("Ant-v3", "thread", 8, (1, 0), (0, 0)),
    ("PongClassic-v5", "thread", 4, (0, 1), (1, 1)),
    ("Ant-v3", "subprocess", 8, (1, 0), (0, 0)),
])
def test_host_engine_launches_once_per_env_step(cuda, task, engine, n,
                                                per_step, per_recv):
    """No plain fallback hides a kernel, and no count is lost to the
    worker threads or processes: env_step (Ant) and pong_render (Pong)
    launch once per host env step, grayscale and resize once per
    PongClassic recv."""
    steps = 6
    _, _, launches = run_host_pool(task, cuda, engine, n=n, steps=steps)
    want = [steps * n * k for k in per_step] + [steps * k for k in per_recv]
    assert launches == want


def test_library_builds_once_when_eight_threads_first_touch_a_kernel(
        cuda, monkeypatch, tmp_path):
    """Eight threads launch env_step together on a fresh build directory:
    one nvcc build serves them all, and every launch is counted."""
    from repro_torch.kernels import build

    builds = []
    compile_ = build._compile

    def counted(nvcc, sources, out):
        builds.append(out)
        compile_(nvcc, sources, out)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_compile", counted)
    build._load.cache_clear()
    state, action, cost, reward0 = env_inputs(33, 9)
    barrier = threading.Barrier(8)
    results = []
    try:
        before = env_multi_step.launches

        def first_touch():
            barrier.wait()
            results.append(env_multi_step(state, action, cost, reward0,
                                          n_sub=10))

        threads = [threading.Thread(target=first_touch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        assert len(builds) == 1 and len(results) == 8
        assert env_multi_step.launches - before == 8
        for r in results:
            assert torch.equal(r[0], results[0][0])
    finally:
        build._load.cache_clear()
