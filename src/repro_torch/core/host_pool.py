"""ThreadEnvPool — the paper's host engine (``repro/core/host_pool.py``).

A fixed pool of worker threads (paper §3.3) consumes (env_id, action)
work items from the ActionBufferQueue, steps the environment, and writes
results into pre-allocated StateBufferQueue blocks.  ``recv`` returns
one block of ``batch_size`` results — the first M environments to
finish (paper §3.2).

Environments here are *host* envs: objects with ``reset()``/``step(a)``
that take and return numpy.  ``TorchHostEnv`` is one env of the port as
one lane (N = 1) of its batched env, stepped on the pool's device: on
the card, Ant's step is the env_step kernel and PongClassic's observe
the pong_render kernel, launched from the worker threads.  The pure
numpy envs of ``envs/host_numpy.py`` play the original Python envs of
the paper's Table 2.

The queues are host memory, as EnvPool's are.  ``recv`` copies the
assembled block to the pool's device once and runs the transform
pipeline there (``HostRecvStage``), the same ``TransformPipeline`` the
device engine fuses into its recv, so PongClassic-v5's grayscale and
resize run as kernels over the block of M.  What ``recv``, ``step`` and
``reset`` return is the JAX package's dict of nine fields, as tensors on
the pool's device; ``send`` takes numpy or tensors on any device.
"""

from __future__ import annotations

import atexit
import functools
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.buffers import ActionBufferQueue, StateBufferQueue
from repro_torch.core.scheduler import numpy_priority
from repro_torch.core.specs import ArraySpec, EnvSpec, TimeStep
from repro_torch.core.transforms import TransformPipeline
from repro_torch.envs.batch import as_batch_env
from repro_torch.obs.telemetry import HostTelemetry

_RESET = object()  # sentinel action: reset the env
_STOP = object()   # sentinel work item: worker shutdown

# Eager PyTorch lets go of the GIL inside every op and takes it back
# after: workers that step torch envs at once hand the GIL to each other
# between ops, and an N = 1 step is some thousand ops of microseconds
# each, so every worker added slows them all (scripts/host_threads.py).
# A TorchHostEnv steps under this lock: one step at a time, whole.
_STEP_LOCK = threading.Lock()

# the recv dict's keys, the fields of a TimeStep
FIELDS = ("obs", "reward", "done", "terminated", "truncated", "env_id",
          "episode_return", "episode_length", "step_cost")


def to_numpy(x: Any) -> np.ndarray:
    """Actions or ids as the caller gives them (numpy, a list, or a
    tensor on any device) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def result_fields(obs_spec: ArraySpec) -> dict[str, tuple[tuple, Any]]:
    """field -> (shape of one row, numpy dtype) of a raw result block."""
    return {
        "obs": (tuple(obs_spec.shape), numpy_dtype(obs_spec.dtype)),
        "reward": ((), np.float32),
        "done": ((), np.bool_),
        "terminated": ((), np.bool_),
        "truncated": ((), np.bool_),
        "env_id": ((), np.int32),
        "episode_return": ((), np.float32),
        "episode_length": ((), np.int32),
        "step_cost": ((), np.int32),
    }


class HostRecvStage:
    """The transform stage of a host recv: the assembled numpy block is
    copied to ``device`` once, and the pipeline runs over it there on the
    rows of its state that the block's ``env_id`` select (gather, apply,
    scatter, as the device engine's recv does)."""

    def __init__(self, transforms: Any, spec: EnvSpec, num_envs: int,
                 device: torch.device | str):
        self.pipeline = TransformPipeline(transforms, spec)
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.restart()

    def restart(self) -> None:
        """Fresh pipeline state: every episode restarts (the device
        engine rebuilds ``tf_state`` in ``init``)."""
        self.tf_state = self.pipeline.init(self.num_envs, self.device)

    def __call__(self, out: dict[str, np.ndarray]
                 ) -> dict[str, torch.Tensor]:
        block = {k: torch.from_numpy(out[k]).to(self.device) for k in FIELDS}
        if not self.pipeline:
            return block
        ids = block["env_id"].long()
        state, ts = self.pipeline.apply(
            self.pipeline.gather(self.tf_state, ids), TimeStep(**block))
        self.tf_state = self.pipeline.scatter(self.tf_state, ids, state)
        return {k: getattr(ts, k) for k in FIELDS}


def _close_at_exit(pool_ref: weakref.ref) -> None:
    """atexit hook: close a still-live pool BEFORE interpreter teardown.

    Daemon workers don't keep the process alive, but a worker still
    inside an env step (a CUDA launch, a torch op) when the runtime
    starts tearing down can abort the whole process.  Joining the
    workers while Python is still fully alive avoids that; ``__del__``
    alone can't guarantee it (shutdown-order dependent)."""
    pool = pool_ref()
    if pool is not None:
        try:
            pool.close()
        except Exception:
            pass


class HostEnv:
    """Host environment interface for the thread/process engines:
    ``reset() -> obs`` and ``step(action) -> (obs, reward, done,
    info)``, numpy in and out."""

    spec: EnvSpec

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action) -> tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError


class TorchHostEnv(HostEnv):
    """One env of the port as a host env; it stands for the JAX
    package's ``JittedHostEnv``.

    The env is one lane (N = 1) of its batched view
    (``envs/batch.py::as_batch_env``) on ``device``, so on the card
    Ant's step is the env_step kernel at N = 1 and PongClassic's
    observe the pong_render kernel at N = 1, each the same per-lane
    computation as the device engine's.  ``JittedHostEnv`` compiles its
    step into one XLA call, which lets go of the GIL for the whole step;
    here it is the eager ops of one batched step, run under one
    process-wide lock (``_STEP_LOCK``).  ``done``, ``reward`` and the
    info reach the host once per step, as ``JittedHostEnv``'s
    ``float(ts.reward)`` does.
    """

    def __init__(self, env, init_key: Any,
                 device: torch.device | str = "cpu",
                 batched: bool | None = None):
        self.benv = as_batch_env(env, native=batched)
        self.spec = env.spec
        self.device = torch.device(device)
        # the init key gives host and device engines the same per-env
        # reset keys (engine conformance); after the first reset the
        # env's own rng chain takes over, so auto-resets agree too
        self._init_key = torch.as_tensor(
            init_key, dtype=torch.int64).to(self.device)
        self._resets = 0
        self._state = None

    def _obs(self) -> np.ndarray:
        return self.benv.v_observe(self._state)[0].cpu().numpy()

    def reset(self) -> np.ndarray:
        # the first reset takes the key as it is; later ones fold in a
        # counter so repeated resets still give fresh episodes
        key = self._init_key
        if self._resets:
            key = random.fold_in(key, self._resets)
        self._resets += 1
        with _STEP_LOCK:
            self._state = self.benv.v_init_state(key[None])
            return self._obs()

    def step(self, action):
        with _STEP_LOCK:
            a = torch.as_tensor(np.asarray(action)).to(
                self.device, self.spec.act_spec.dtype)[None]
            self._state, ts = self.benv.v_step(self._state, a)
            # finalize leaves ts.obs None: the obs is the post-step
            # state's
            obs = self._obs()
            reward, done, term, trunc, ep_ret, ep_len, cost = torch.cat([
                x.to(torch.float64) for x in (
                    ts.reward, ts.done, ts.terminated, ts.truncated,
                    ts.episode_return, ts.episode_length, ts.step_cost)
            ]).tolist()
        return obs, reward, bool(done), {
            "terminated": bool(term),
            "truncated": bool(trunc),
            "episode_return": ep_ret,
            "episode_length": int(ep_len),
            "step_cost": int(cost),
        }


class ThreadEnvPool:
    """EnvPool's C++ engine, re-built on Python threads (paper
    §3.1–3.3), serving its blocks on ``device``."""

    def __init__(
        self,
        env_fns: list[Callable[[], HostEnv]],
        batch_size: int | None = None,
        num_threads: int | None = None,
        schedule: str = "fifo",
        cost_ema_alpha: float = 1.0,
        transforms: Any = (),
        obs: bool = True,
        device: torch.device | str = "cpu",
    ):
        self.num_envs = len(env_fns)
        self.batch_size = batch_size or self.num_envs
        if self.batch_size > self.num_envs:
            raise ValueError("batch_size cannot exceed num_envs")
        if schedule not in ("fifo", "sjf"):
            raise ValueError(
                "thread engine supports schedules ('fifo', 'sjf'); "
                f"{schedule!r} is the cross-shard policy "
                "(use engine='device-sharded')"
                if schedule == "hierarchical" else
                f"unknown schedule {schedule!r}; the thread engine knows "
                "('fifo', 'sjf')")
        # paper §3.3: thread count bounded by cores; envs 2-3x threads
        self.num_threads = num_threads or min(self.num_envs,
                                              os.cpu_count() or 1)
        # numpy mirror of core/scheduler.py: ``send`` enqueues work in
        # policy-priority order, so workers pull (and thus finish) the
        # scheduled lanes first and recv's "first M finished" block is
        # policy-shaped.  sjf orders by an EMA of each env's observed
        # step_cost: ``cost_ema_alpha=1.0`` is the last-observed
        # estimator; a lower alpha keeps a lane's heavy history through
        # one cheap step.  fifo keeps the caller's order.
        if not 0.0 < cost_ema_alpha <= 1.0:
            raise ValueError(
                f"cost_ema_alpha must be in (0, 1], got {cost_ema_alpha}")
        self.schedule = schedule
        self.cost_ema_alpha = float(cost_ema_alpha)
        self._est_cost = np.ones(self.num_envs, np.float32)
        # numpy mirror of the device engine's counters (obs/telemetry.py)
        self.obs = bool(obs)
        self._tele = HostTelemetry(self.num_envs) if self.obs else None

        self._envs = [fn() for fn in env_fns]
        self.device = torch.device(device)
        self.raw_spec = self._envs[0].spec
        self._stage = HostRecvStage(transforms, self.raw_spec, self.num_envs,
                                    self.device)
        self.spec = self._stage.pipeline.out_spec

        self._actions = ActionBufferQueue(self.num_envs)
        self._states = StateBufferQueue(result_fields(self.raw_spec.obs_spec),
                                        self.batch_size, self.num_envs)
        self._running = True
        self._close_lock = threading.Lock()
        # first worker exception: (env_id, formatted traceback).  recv
        # re-raises it instead of waiting out the block timeout.
        self._error: tuple[int, str] | None = None
        self._error_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"envpool-{i}")
            for i in range(self.num_threads)
        ]
        # a dropped (never-closed) pool must neither hang nor abort the
        # interpreter at exit — see _close_at_exit.  weakref so the hook
        # doesn't keep the pool alive; partial so unregister in close()
        # removes exactly this pool's hook.
        self._atexit_cb = functools.partial(_close_at_exit,
                                            weakref.ref(self))
        atexit.register(self._atexit_cb)
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------ #
    def _worker(self) -> None:
        while True:
            # bounded waits + a _running re-check on every block point:
            # a closed pool must never strand a worker in an unbounded
            # queue wait (the semaphores have no close() to wake them)
            try:
                item = self._actions.get(timeout=0.2)
            except TimeoutError:
                if not self._running:
                    return
                continue
            if item is _STOP:
                return
            env_id, action = item
            env = self._envs[env_id]
            try:
                if action is _RESET:
                    obs = env.reset()
                    rew, done, info = 0.0, False, {}
                else:
                    obs, rew, done, info = env.step(action)
            except Exception:
                # the failed item produces no result slot, so its block
                # can never fill — record the traceback for recv to
                # re-raise (the pool is in a terminal error state) and
                # keep the worker alive for a clean close()
                with self._error_lock:
                    if self._error is None:
                        self._error = (env_id, traceback.format_exc())
                continue
            while True:
                try:
                    blk, slot = self._states.acquire_slot(timeout=0.2)
                    break
                except TimeoutError:
                    # result buffer saturated and nobody is recv()ing —
                    # the classic dropped-pool state.  Exit on close()
                    # instead of wedging forever under backpressure.
                    if not self._running:
                        return
            blk.write(slot, {
                "obs": obs,
                "reward": rew,
                "done": done,
                "terminated": info.get("terminated", done),
                "truncated": info.get("truncated", False),
                "env_id": env_id,
                "episode_return": info.get("episode_return", 0.0),
                "episode_length": info.get("episode_length", 0),
                "step_cost": info.get("step_cost", 1),
            })

    # ------------------------------------------------------------------ #
    # EnvPool API
    # ------------------------------------------------------------------ #
    def async_reset(self) -> None:
        """Enqueue a reset for every env (paper A.3: call once at start);
        the transform pipeline restarts with the episodes."""
        self._stage.restart()
        if self._tele is not None:
            self._tele.on_enqueue(np.arange(self.num_envs), stepped=False)
        self._actions.put_batch([(i, _RESET) for i in range(self.num_envs)])

    def send(self, actions: Any, env_ids: Any) -> None:
        """Queue ``actions[j]`` for env ``env_ids[j]``; numpy, lists or
        tensors on any device."""
        actions, ids = to_numpy(actions), to_numpy(env_ids).astype(np.int64)
        if self._tele is not None:
            self._tele.on_enqueue(ids, stepped=True)
        items = [(int(e), a) for e, a in zip(ids, actions)]
        if self.schedule != "fifo":
            pri = numpy_priority(self.schedule, self._est_cost[ids])
            items = [items[j] for j in np.argsort(pri, kind="stable")]
        self._actions.put_batch(items)

    def _raise_worker_error(self) -> None:
        env_id, tb = self._error  # type: ignore[misc]
        raise RuntimeError(
            f"ThreadEnvPool worker failed on env {env_id} (pool is dead; "
            f"close() it):\n{tb}")

    def recv(self, timeout: float | None = 60.0) -> dict[str, torch.Tensor]:
        """One block of ``batch_size`` results on the pool's device.  A
        worker exception is re-raised here (and on every later recv)
        instead of letting the never-filling block run out the full
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._error is not None:
                self._raise_worker_error()
            wait = 0.05
            if deadline is not None:
                wait = min(wait, max(deadline - time.monotonic(), 0.0))
            try:
                out = self._states.take(timeout=wait)
                break
            except TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    # a worker may have failed DURING this final take —
                    # without this re-check the real error would be
                    # masked by a spurious TimeoutError
                    if self._error is not None:
                        self._raise_worker_error()
                    raise
        ids = out["env_id"]
        if self._tele is not None:
            self._tele.record_block(ids, out["step_cost"])
        # refresh the per-env cost estimates the sjf mirror orders by
        observed = np.maximum(out["step_cost"], 1).astype(np.float32)
        a = self.cost_ema_alpha
        self._est_cost[ids] = a * observed + (1.0 - a) * self._est_cost[ids]
        return self._stage(out)

    def step(self, actions: Any, env_ids: Any) -> dict[str, torch.Tensor]:
        self.send(actions, env_ids)
        return self.recv()

    def reset(self) -> dict[str, torch.Tensor]:
        """Synchronous reset: every env resets and ONE full batch comes
        back.  Only well-defined when ``batch_size == num_envs`` — with
        a smaller batch the first recv would hold just the first
        ``batch_size`` finishers while the rest stay queued, so that
        case raises: async pools use ``async_reset()`` + the send/recv
        loop (paper A.3)."""
        if self.batch_size < self.num_envs:
            raise RuntimeError(
                f"reset() on an async ThreadEnvPool (batch_size="
                f"{self.batch_size} < num_envs={self.num_envs}) would "
                "return a partial batch; use async_reset() and recv()")
        self.async_reset()
        return self.recv()

    def stats(self) -> dict:
        """Telemetry snapshot, the device engine's keys and semantics."""
        if self._tele is None:
            raise RuntimeError(
                "telemetry disabled: pool was constructed with obs=False")
        return self._tele.snapshot()

    def close(self) -> None:
        """Idempotent and safe under concurrent calls (e.g. an explicit
        ``close()`` racing ``__del__`` at interpreter shutdown): exactly
        one caller wins the flag flip under the lock and performs the
        shutdown; everyone else returns immediately."""
        with self._close_lock:
            if not self._running:
                return
            self._running = False
        atexit.unregister(self._atexit_cb)
        # sentinels wake idle workers immediately; workers wedged on
        # result-buffer backpressure exit via their _running poll, so a
        # FULL action ring must not turn this into an unbounded block —
        # drop the sentinels on timeout rather than hang the closer
        try:
            self._actions.put_batch([_STOP] * self.num_threads, timeout=1.0)
        except TimeoutError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = [
    "FIELDS", "HostEnv", "HostRecvStage", "ThreadEnvPool", "TorchHostEnv",
    "numpy_dtype", "result_fields", "to_numpy",
]
