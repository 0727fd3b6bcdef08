"""The port's CUDA kernels against their plain PyTorch versions on the
card (bitwise), and a pool on the card against the same pool on the CPU.
These need a CUDA device: each test is marked ``gpu`` and skips without
one.  Run them on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, and ``--noconftest`` skips tests/conftest.py,
which does: the machine with the card may have no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels.env_step.ops import env_multi_step  # noqa: E402
from repro_torch.kernels.image import ops  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_env_step_kernel_is_bitwise(cuda):
    rng = np.random.default_rng(0)
    n = 1000                       # not a multiple of the block size
    state = rng.normal(0, 0.5, (n, 28)).astype(np.float32)
    state[:, 2] = rng.uniform(0.15, 0.9, n)
    args = [torch.from_numpy(x).to(cuda) for x in (
        state, rng.uniform(-1.3, 1.3, (n, 8)).astype(np.float32),
        rng.integers(0, 10, n).astype(np.int32),
        rng.normal(0, 1, n).astype(np.float32))]
    for backend_args in (args, args[:2]):
        got = env_multi_step(*backend_args, n_sub=9)
        want = env_multi_step(*backend_args, n_sub=9, backend="reference")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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
