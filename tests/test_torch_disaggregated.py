"""``rl/ppo.py::train_disaggregated`` against ``repro``'s: two processes,
env process 0 (two shards) and learner process 1, each running both
packages' trainers (tests/_torch_disaggregated_check.py; ``repro``'s
under ``jax.distributed``, the port's under ``torch.distributed`` over
gloo).  Ant-v3 N=8, two iterations: the history within 1e-4, the
learner's params within 1e-5.

PongClassic-v5's default CNN, past 2^20 parameters, is sharded over the
env processes by ``policy_shardings``; that needs two env processes, so
it runs in a job of its own, three processes (env 0 and 1, learner 2),
started with the first: each env process holds half of each of the 11
sharded leaves and gathers the policy once an iteration, and the
history and params agree with ``repro``'s by the same bounds.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import repro_torch  # noqa: E402
import repro_torch.rl.ppo as tppo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one OpenMP thread a child: the suite's xdist workers share the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
CHECK = os.path.join(ROOT, "tests", "_torch_disaggregated_check.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(count: int, *extra: str) -> list:
    ports = [str(free_port()), str(free_port())]
    return [subprocess.Popen([sys.executable, CHECK, str(i), *ports, *extra],
                             env=ENV, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for i in range(count)]


def results(procs: list) -> list:
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


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs, started together: the Ant-v3 pair and the CNN trio."""
    out_dir = str(tmp_path_factory.mktemp("disaggregated"))
    return spawn(2), spawn(3, "cnn", out_dir), out_dir


@pytest.fixture(scope="module")
def runs(jobs):
    return results(jobs[0])


@pytest.fixture(scope="module")
def cnn(jobs):
    return results(jobs[1]), jobs[2]


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


def test_cnn_env_processes_hold_half_of_each_sharded_leaf(cnn):
    runs, _ = cnn
    whole = {"conv1.w": [32, 4, 8, 8], "conv1.b": [32],
             "conv2.w": [64, 32, 4, 4], "conv2.b": [64],
             "conv3.w": [64, 64, 3, 3], "conv3.b": [64],
             "fc.w": [3136, 512], "fc.b": [512], "pi.w": [512, 6],
             "pi.b": [6], "v.w": [512, 1], "v.b": [1]}
    for r in runs[:2]:
        assert r["port"]["local_shards"] == 1
        held = r["port"]["held"][0]
        assert held.keys() == whole.keys()
        assert held["v.b"] == [1]
        for k in whole:
            if k != "v.b":
                assert held[k] != whole[k]
                assert 2 * int(np.prod(held[k])) == int(np.prod(whole[k]))
    # the learner holds no shard and gathers nothing
    assert runs[2]["port"]["held"] == [] and runs[2]["port"]["gathers"] == []


def test_cnn_env_processes_gather_once_an_iteration(cnn):
    """The prologue's collect, one collect an iteration (two), and the
    params returned at the end: one ``"policy"`` gather each."""
    runs, _ = cnn
    for r in runs[:2]:
        assert r["port"]["gathers"] == [1, 2, 3, 4]


@pytest.mark.parametrize("pid", [0, 1, 2])
def test_cnn_history_and_params_match_repro(cnn, pid):
    runs, out_dir = cnn
    jh, th = runs[pid]["repro"]["history"], runs[pid]["port"]["history"]
    assert len(jh) == len(th) == 2
    for a, b in zip(jh, th):
        assert set(a) == set(b)
        for k in a:
            if k != "time_s":
                assert abs(a[k] - b[k]) <= 1e-4, (pid, k, a[k], b[k])
    want = np.load(os.path.join(out_dir, f"repro{pid}.npz"))
    got = np.load(os.path.join(out_dir, f"port{pid}.npz"))
    learner = np.load(os.path.join(out_dir, "port2.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        # every process returns the learner's params
        np.testing.assert_array_equal(got[k], learner[k])
