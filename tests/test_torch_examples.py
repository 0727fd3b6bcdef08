"""The port's five examples (``examples/*_torch.py``) run as a user runs
them, with ``--device cpu`` at a toy size, each in a subprocess (all
five at once): each exits 0, prints its JAX counterpart's fields and a
rate, and imports neither ``jax`` nor ``repro``."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (argv at a toy size, what its output must hold)
EXAMPLES = {
    "quickstart_torch": ([], ["reset obs: (16, 4, 84, 84)",
                              "transformed spec: (4, 84, 84) torch.float32",
                              "pool stats: recvs=2 served=32 stepped=16",
                              "async env_ids:", "async env steps/s:",
                              "thread pool batch: (4, 4)", "OK"]),
    "async_vs_sync_torch": ([], ["== TokenSkew-v0", "sync   N=64 M=64:",
                                 "async  N=128 M=16:", "x sync)",
                                 "mesh=1, N=16 M=4", "hierarchical:",
                                 "tokens/s", "x fifo)"]),
    "ppo_atari_torch": (["--num-envs", "2", "--num-steps", "4",
                         "--total-steps", "16"],
                        ["[ppo_atari] task=PongClassic-v5 obs_spec=(4, 84, "
                         "84) pipeline=['Grayscale', 'Resize', "
                         "'FrameStack', 'RewardClip']", '"iter": 1',
                         '"env_steps": 16', '"mean_return"',
                         "[ppo_atari] env steps/s:"]),
    "serve_lm_torch": (["--lanes", "2", "--requests", "4", "--max-new", "8",
                        "--prompt-len", "6"],
                       ["mode=continuous schedule=fifo lanes=2 requests=4",
                        "block steps", "lane utilization", "tok/s"]),
    "sharded_scaleout_torch": (["--shards", "2", "--envs-per-shard", "2",
                                "--steps", "4"],
                               ["mesh=1  envs=   2", "mesh=2  envs=   4",
                                "steps/s", "frames/collect"]),
}

# runs the example as ``python examples/<name>.py``, then asserts it
# pulled in no jax and no repro
RUNNER = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = [path] + sys.argv[2:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'repro'))\n"
    "assert not bad, bad\n"
)


@pytest.fixture(scope="module")
def runs():
    """Every example started at once; name -> its Popen."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MESH="1")
    return {name: subprocess.Popen(
        [sys.executable, "-c", RUNNER,
         os.path.join(ROOT, "examples", f"{name}.py"), *argv,
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, (argv, _) in EXAMPLES.items()}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, name):
    out, err = runs[name].communicate(timeout=300)
    assert runs[name].returncode == 0, err[-3000:]
    for field in EXAMPLES[name][1]:
        assert field in out, (field, out)


def test_examples_default_to_the_card():
    """Each example's ``--device`` defaults to ``cuda``: no quiet
    fallback to the CPU."""
    for name in EXAMPLES:
        with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
            src = f.read()
        assert 'ap.add_argument("--device", default="cuda"' in src, name
