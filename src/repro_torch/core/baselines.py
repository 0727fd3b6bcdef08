"""Baseline executors from the paper's Table 1: For-loop and Subprocess
(``repro/core/baselines.py``).

* ``ForLoopEnv`` — all envs stepped sequentially in the caller's thread.
* ``SubprocessEnv`` — gym.vector-style: worker processes step their env
  shard and write observations into shared memory; the parent coordinates
  over pipes.  This is the "most popular implementation" the paper
  benchmarks against (Brockman et al. 2016).

Both are synchronous (M = N) and return the same dict as
``ThreadEnvPool.recv``, tensors on the pool's device; both also satisfy
the ``core.protocol.EnvPool`` contract (send parks a batch, recv
executes it) so protocol-driven code runs unchanged over them.  Workers
step raw envs; the parent applies the transform pipeline to each
assembled block on the pool's device (``HostRecvStage``).

The JAX package's subprocess workers send back only reward and done;
these send every field, so the subprocess stream, its ``step_cost`` and
its ``stats()`` equal the for-loop's.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import threading
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.host_pool import (
    HostEnv,
    HostRecvStage,
    numpy_dtype,
    result_fields,
    to_numpy,
)
from repro_torch.kernels.backend import launch_counts
from repro_torch.obs.telemetry import HostTelemetry

# the info fields a step fills besides obs, reward and done
_INFO = ("terminated", "truncated", "episode_return", "episode_length",
         "step_cost")


def _result_block(n: int, obs_spec) -> dict[str, np.ndarray]:
    out = {k: np.zeros((n,) + shape, dtype)
           for k, (shape, dtype) in result_fields(obs_spec).items()}
    out["env_id"][:] = np.arange(n)
    out["step_cost"][:] = 1
    return out


def _info_row(done: bool, info: dict) -> tuple:
    """A step's info fields, in ``_INFO`` order, with the host pool's
    defaults."""
    return (info.get("terminated", done), info.get("truncated", False),
            info.get("episode_return", 0.0), info.get("episode_length", 0),
            info.get("step_cost", 1))


class _SyncSendRecv:
    """send/recv facade for synchronous engines (EnvPool protocol):
    ``send`` parks one full batch of actions, ``recv`` executes it.
    Exactly one send may be outstanding (M == N: there is only one
    block in flight by construction)."""

    _pending: "tuple | str | None" = None

    def send(self, actions: Any, env_ids: Any = None) -> None:
        if self._pending is not None:
            raise RuntimeError(
                "send() called twice without recv() on a sync engine")
        self._pending = (actions, env_ids)

    def recv(self) -> dict[str, torch.Tensor]:
        if self._pending is None:
            raise RuntimeError("recv() without a pending send()/async_reset()")
        pending, self._pending = self._pending, None
        if pending == "reset":
            return self.reset()
        actions, env_ids = pending
        return self.step(actions, env_ids)

    def async_reset(self) -> None:
        """Paper A.3 analogue: park a reset; the next recv returns it."""
        if self._pending is not None:
            raise RuntimeError("async_reset() with a send() outstanding")
        self._pending = "reset"

    def _serve(self, out: dict[str, np.ndarray], stepped: bool
               ) -> dict[str, torch.Tensor]:
        """Count the block (every env was sent work this tick) and run
        it through the transform stage."""
        if self._tele is not None:
            self._tele.on_enqueue(out["env_id"], stepped=stepped)
            self._tele.record_block(out["env_id"], out["step_cost"])
        return self._stage(out)

    def stats(self) -> dict:
        """Telemetry snapshot (``core/protocol.py`` ``stats()``)."""
        if self._tele is None:
            raise RuntimeError(
                "telemetry disabled: pool was constructed with obs=False")
        return self._tele.snapshot()


class ForLoopEnv(_SyncSendRecv):
    """Paper Table 1 row 1: single-thread sequential stepping.  Env ``i``
    takes ``actions[i]``; the block's ``env_id`` is ``0..N-1``."""

    def __init__(self, env_fns: list[Callable[[], HostEnv]],
                 transforms: Any = (), obs: bool = True,
                 device: torch.device | str = "cpu"):
        self._envs = [fn() for fn in env_fns]
        self.num_envs = len(self._envs)
        self.batch_size = self.num_envs
        self.obs = bool(obs)
        self._tele = HostTelemetry(self.num_envs) if self.obs else None
        self.device = torch.device(device)
        self.raw_spec = self._envs[0].spec
        self._stage = HostRecvStage(transforms, self.raw_spec, self.num_envs,
                                    self.device)
        self.spec = self._stage.pipeline.out_spec

    def reset(self) -> dict[str, torch.Tensor]:
        # pipeline state restarts with the envs (device init() parity)
        self._stage.restart()
        out = _result_block(self.num_envs, self.raw_spec.obs_spec)
        for i, e in enumerate(self._envs):
            out["obs"][i] = e.reset()
        return self._serve(out, stepped=False)

    def step(self, actions: Any, env_ids: Any = None
             ) -> dict[str, torch.Tensor]:
        actions = to_numpy(actions)
        out = _result_block(self.num_envs, self.raw_spec.obs_spec)
        for i, e in enumerate(self._envs):
            obs, rew, done, info = e.step(actions[i])
            out["obs"][i] = obs
            out["reward"][i] = rew
            out["done"][i] = done
            for k, v in zip(_INFO, _info_row(done, info)):
                out[k][i] = v
        return self._serve(out, stepped=True)

    def close(self) -> None:
        pass


def _subproc_worker(conn, shm_name, shape, dtype_str, lo, hi, factory_bytes):
    """Worker process: owns envs [lo, hi); writes obs into shared memory
    and sends back each env's reward, done and info fields, or on
    ``launches`` its kernels' launch counts."""
    factory = pickle.loads(factory_bytes)
    envs = [factory(i) for i in range(lo, hi)]
    shm = shared_memory.SharedMemory(name=shm_name)
    obs_block = np.ndarray(shape, dtype=np.dtype(dtype_str), buffer=shm.buf)
    try:
        while True:
            cmd, payload = conn.recv()
            if cmd == "close":
                break
            try:
                if cmd == "reset":
                    for i, e in enumerate(envs):
                        obs_block[lo + i] = e.reset()
                    conn.send(("ok", None))
                elif cmd == "step":
                    rows = []
                    for i, e in enumerate(envs):
                        obs, rew, done, info = e.step(payload[i])
                        obs_block[lo + i] = obs  # one IPC copy saved
                        rows.append((rew, done) + _info_row(done, info))
                    conn.send(("ok", rows))
                elif cmd == "launches":
                    conn.send(("ok", launch_counts()))
            except Exception:
                # env raised: ship the traceback instead of dying with
                # the reply unsent (which would hang the parent's recv)
                conn.send(("err", traceback.format_exc()))
    finally:
        del obs_block
        shm.close()
        conn.close()


class SubprocessEnv(_SyncSendRecv):
    """Paper Table 1 row 2: multiprocessing with shared-memory obs.
    Workers start with ``spawn``; on the card each opens its own CUDA
    context, so the kernel library must be built before they start
    (``core/registry.py`` does)."""

    def __init__(
        self,
        env_factory: Callable[[int], HostEnv],
        num_envs: int,
        num_workers: int | None = None,
        spec=None,
        transforms: Any = (),
        obs: bool = True,
        device: torch.device | str = "cpu",
    ):
        self.num_envs = num_envs
        self.batch_size = num_envs
        self.obs = bool(obs)
        self._tele = HostTelemetry(num_envs) if self.obs else None
        if spec is None:
            spec = env_factory(0).spec
        self.device = torch.device(device)
        self.raw_spec = spec
        self._stage = HostRecvStage(transforms, spec, num_envs, self.device)
        self.spec = self._stage.pipeline.out_spec

        ctx = mp.get_context("spawn")  # fork is unsafe with a CUDA context
        self.num_workers = min(num_workers or num_envs, num_envs)
        obs_spec = spec.obs_spec
        shape = (num_envs,) + tuple(obs_spec.shape)
        dtype = numpy_dtype(obs_spec.dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        self._shm = shared_memory.SharedMemory(create=True,
                                               size=max(nbytes, 1))
        self._obs = np.ndarray(shape, dtype=dtype, buffer=self._shm.buf)

        factory_bytes = pickle.dumps(env_factory)
        bounds = np.linspace(0, num_envs, self.num_workers + 1).astype(int)
        self._conns, self._procs, self._bounds = [], [], []
        for w in range(self.num_workers):
            lo, hi = int(bounds[w]), int(bounds[w + 1])
            if lo == hi:
                continue
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_subproc_worker,
                args=(child, self._shm.name, shape, dtype.str, lo, hi,
                      factory_bytes),
                daemon=True,
            )
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
            self._bounds.append((lo, hi))
        self._closed = False
        self._close_lock = threading.Lock()
        self._error: str | None = None

    # ------------------------------------------------------------------ #
    # worker error propagation: the first traceback shipped back by a
    # worker puts the pool in a terminal error state, re-raised by every
    # subsequent reset/step/recv (instead of hanging on a dead pipe)
    # ------------------------------------------------------------------ #
    def _raise_worker_error(self) -> None:
        raise RuntimeError(
            "SubprocessEnv worker failed (pool is dead; close() it):\n"
            + (self._error or ""))

    def _recv_checked(self, conn):
        tag, payload = conn.recv()
        if tag == "err":
            self._error = payload
            self._raise_worker_error()
        return payload

    def recv(self) -> dict[str, torch.Tensor]:
        if self._error is not None:
            self._raise_worker_error()
        return super().recv()

    def reset(self) -> dict[str, torch.Tensor]:
        if self._error is not None:
            self._raise_worker_error()
        # pipeline state restarts with the envs (device init() parity)
        self._stage.restart()
        for c in self._conns:
            c.send(("reset", None))
        for c in self._conns:
            self._recv_checked(c)
        out = _result_block(self.num_envs, self.raw_spec.obs_spec)
        out["obs"][:] = self._obs  # batching copy (the paper counts this)
        return self._serve(out, stepped=False)

    def step(self, actions: Any, env_ids: Any = None
             ) -> dict[str, torch.Tensor]:
        if self._error is not None:
            self._raise_worker_error()
        actions = to_numpy(actions)
        for c, (lo, hi) in zip(self._conns, self._bounds):
            c.send(("step", actions[lo:hi]))
        out = _result_block(self.num_envs, self.raw_spec.obs_spec)
        for c, (lo, hi) in zip(self._conns, self._bounds):
            rows = self._recv_checked(c)
            for k, col in zip(("reward", "done") + _INFO, zip(*rows)):
                out[k][lo:hi] = col
        out["obs"][:] = self._obs
        return self._serve(out, stepped=True)

    def launches(self) -> dict[str, int]:
        """Each kernel's launches in the worker processes, summed: the
        envs step there, so this process's ``fn.launches`` miss them."""
        if self._error is not None:
            self._raise_worker_error()
        for c in self._conns:
            c.send(("launches", None))
        total: dict[str, int] = {}
        for c in self._conns:
            for k, v in self._recv_checked(c).items():
                total[k] = total.get(k, 0) + v
        return total

    def close(self) -> None:
        """Idempotent and safe under concurrent calls (an explicit
        ``close()`` racing ``__del__`` at interpreter shutdown), like
        ``ThreadEnvPool.close()``: exactly one caller wins the flag flip
        under the lock and performs the shutdown."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for c in self._conns:
            try:
                c.send(("close", None))
                c.close()
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        del self._obs
        self._shm.close()
        self._shm.unlink()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["ForLoopEnv", "SubprocessEnv"]
