"""``rl/ppo.py::train_disaggregated`` against ``repro``'s: two processes,
env process 0 (two shards) and learner process 1, each running both
packages' trainers (tests/_torch_disaggregated_check.py; ``repro``'s
under ``jax.distributed``, the port's under ``torch.distributed`` over
gloo).  Ant-v3 N=8, two iterations: the history within 1e-4, the
learner's params within 1e-5.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
import repro_torch.rl.ppo as tppo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
CHECK = os.path.join(ROOT, "tests", "_torch_disaggregated_check.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    ports = [str(free_port()), str(free_port())]
    procs = [subprocess.Popen([sys.executable, CHECK, str(i), *ports],
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads([ln for ln in stdout.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def flat(params) -> list:
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in flat(params[k])]
    return [np.asarray(params, np.float64)]


@pytest.mark.parametrize("pid", [0, 1])
def test_history_matches_repro_on_every_process(runs, pid):
    jh, th = runs[pid]["repro"]["history"], runs[pid]["port"]["history"]
    assert len(jh) == len(th) == 2
    for a, b in zip(jh, th):
        assert set(a) == set(b)
        for k in a:
            if k != "time_s":
                assert abs(a[k] - b[k]) <= 1e-4, (pid, k, a[k], b[k])
    assert runs[pid]["port"]["history"] == [
        {**h, "time_s": th[i]["time_s"]}
        for i, h in enumerate(runs[1 - pid]["port"]["history"])]


def test_learner_params_match_repro(runs):
    learner = runs[1]
    assert (learner["port"]["local_shards"], runs[0]["port"]["local_shards"]
            ) == (0, 2)
    for a, b in zip(flat(learner["repro"]["params"]),
                    flat(learner["port"]["params"])):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_env_process_returns_the_learners_params(runs):
    for a, b in zip(flat(runs[0]["port"]["params"]),
                    flat(runs[1]["port"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_a_mesh_over_the_learner_is_refused(runs):
    for r in runs:
        assert "overlaps the learner" in r["port"]["overlap"], r["port"]


def test_one_process_is_refused():
    pool = repro_torch.make("Ant-v3", 8, engine="device-sharded",
                            num_shards=2, device="cpu")
    with pytest.raises(ValueError, match=">= 2 processes"):
        tppo.train_disaggregated(pool, tppo.PPOConfig())
