"""The port's sharded engine across processes: two gloo ranks on
localhost, one shard each, against one process holding both shards
(tests/_torch_multihost_check.py, no JAX).  The streams, as the whole
mesh sees them, and ``stats()`` are bitwise the same; a recv issues only
the two allowed collective families, none of env-data size; one
iteration of ``train_device`` and ``train_pipelined`` (each process
gathering the rollout) gives the same params as in one process.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one OpenMP thread a child: the suite's xdist workers share the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
CHECK = os.path.join(ROOT, "tests", "_torch_multihost_check.py")
TASKS = ("TokenCopy-v0", "Ant-v3", "AntNorm-v3", "PongClassic-v5")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    port = str(free_port())
    cmds = [["solo"], ["rank", "0", port], ["rank", "1", port]]
    procs = [subprocess.Popen([sys.executable, CHECK, *c], env=ENV,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {"solo": outs[0], "ranks": outs[1:]}


def test_process_topology(runs):
    assert runs["solo"]["meta"]["process_count"] == 1
    for i, r in enumerate(runs["ranks"]):
        meta = r["meta"]
        assert (meta["process_count"], meta["process_id"],
                meta["backend"]) == (2, i, "gloo")


@pytest.mark.parametrize("task", TASKS)
def test_ranks_stream_and_stats_equal_solo(runs, task):
    solo = runs["solo"]["rollouts"][task]
    for r in runs["ranks"]:
        got = r["rollouts"][task]
        assert got["sha"] == solo["sha"]
        assert got["stats"] == solo["stats"]
        # each rank holds half the block
        assert 2 * got["block"] == solo["block"]


@pytest.mark.parametrize("task", TASKS)
def test_recv_collectives_are_the_allowed_two(runs, task):
    """The same collectives a recv in solo and in ranks; fifo and sjf
    none, the hierarchical NormalizeObs pool its (D, C) costs and its
    two moment sums, each far below a served block of env data."""
    allowed = {"candidates", "moments"}
    for r in (runs["solo"], *runs["ranks"]):
        recvs = r["rollouts"][task]["collectives"]
        assert recvs == runs["solo"]["rollouts"][task]["collectives"]
        for log in recvs:
            kinds = [k for k, _ in log]
            if task == "AntNorm-v3":
                assert kinds == ["candidates", "moments", "moments"]
            else:
                assert kinds == []
            assert set(kinds) <= allowed
            # AntNorm-v3 M=8: a served block is 8 x 29 f32
            assert all(nbytes < 8 * 29 * 4 for _, nbytes in log)


@pytest.mark.parametrize("driver", ["train_device", "train_pipelined"])
def test_training_across_ranks_equals_solo(runs, driver):
    solo = runs["solo"][driver]
    for r in runs["ranks"]:
        assert r[driver]["loss"] == solo["loss"]
        for a, b in zip(r[driver]["params"], solo["params"]):
            assert abs(a - b) <= 1e-5
