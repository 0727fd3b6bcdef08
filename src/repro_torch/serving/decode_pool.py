"""Continuous-batching decode pool (``repro/serving/decode_pool.py``): the
scheduler's top-M selection applied to token generation.

A fixed block of ``num_lanes`` decode lanes plays the role the env pool
plays for episodes: each lane holds one in-flight request's static
per-lane KV-cache row (the ``LMPolicy`` lane layout), every step decodes
ONE token for every lane in the block, and admission swaps fresh
prompts into finished lanes — fixed block shapes with masked lanes.

* ``continuous=True`` (default): a lane is re-admitted the moment its
  request finishes;
* ``continuous=False``: run-to-completion static batching — the next
  batch is admitted only when EVERY lane has finished.

The host-side request queue is scheduler-fed: ``schedule="fifo"`` keeps
arrival order, ``"sjf"`` admits shortest total work first.

The lanes' caches are written in place (``rl/policy_lm.py``): a step or
an admission consumes the ``ServeLaneState`` it is given.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, publish_serve_stats
from repro_torch.obs.trace import Tracer
from repro_torch.rl.policy_lm import LMPolicy
from repro_torch.utils.tree import tree_dataclass


@tree_dataclass
class ServeLaneState:
    """Per-lane serving state, lane-major (leading dim = num_lanes)."""

    k: torch.Tensor         # (N, n_layers, Hkv, T, hd)
    v: torch.Tensor
    length: torch.Tensor    # (N,) int32 — valid cache entries
    last_tok: torch.Tensor  # (N,) int32 — next token to feed
    active: torch.Tensor    # (N,) bool — lane holds a live request
    req_id: torch.Tensor    # (N,) int32 — request the lane serves (-1 free)
    n_new: torch.Tensor     # (N,) int32 — tokens generated so far
    max_new: torch.Tensor   # (N,) int32 — per-request generation budget


@dataclasses.dataclass
class ServeStats:
    requests: int
    total_tokens: int        # useful generated tokens
    decode_steps: int        # step invocations (each = num_lanes slots)
    lane_slots: int          # decode_steps * num_lanes
    wall_s: float

    @property
    def utilization(self) -> float:
        return self.total_tokens / max(self.lane_slots, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)


class DecodePool:
    """Continuous-batching decode server over ``num_lanes`` KV-cache
    lanes driven by an ``LMPolicy`` backbone, on the policy's device."""

    def __init__(self, policy: LMPolicy, num_lanes: int, max_new: int,
                 eos_token: int | None = None, schedule: str = "fifo",
                 registry: MetricsRegistry | None = None):
        if schedule not in ("fifo", "sjf"):
            raise ValueError(f"unknown serving schedule {schedule!r}")
        self.policy = policy
        self.device = policy.device
        self.num_lanes = int(num_lanes)
        self.max_new = int(max_new)
        self.eos_token = eos_token
        self.schedule = schedule
        # every serve() publishes its ServeStats here when given
        self.registry = registry

    # ------------------------------ state --------------------------- #
    def init_lanes(self) -> ServeLaneState:
        base = self.policy.init_lanes(self.num_lanes)
        n, dev = self.num_lanes, self.device

        def full(value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        return ServeLaneState(
            k=base.k, v=base.v, length=base.length,
            last_tok=full(0, torch.int32), active=full(False, torch.bool),
            req_id=full(-1, torch.int32), n_new=full(0, torch.int32),
            max_new=full(self.max_new, torch.int32),
        )

    # ---------------------------- admission ------------------------- #
    def _admit_impl(self, params: Any, lanes: ServeLaneState,
                    admit: torch.Tensor,        # (N,) bool
                    prompts: torch.Tensor,      # (N, P) int32 (padded)
                    plen: torch.Tensor,         # (N,) int32
                    req_ids: torch.Tensor,      # (N,) int32
                    req_max_new: torch.Tensor,  # (N,) int32
                    ) -> tuple[ServeLaneState, torch.Tensor]:
        """Prefill admitted lanes and emit their first generated token.

        Prefill-as-decode: the prompt streams through the same cached
        ``decode_step`` the hot loop runs, one position per step over
        ALL lanes, masked by ``j < plen``.  Lanes outside ``admit`` are
        scribbled on at position 0 and restored afterwards from a copy
        of their rows, which gives the JAX package's ``where(admit, new,
        old)``; decoding every lane keeps the batch size, and so the
        rounding of the products, the same as the JAX program's."""
        pol = self.policy
        keep = torch.nonzero(~admit)[:, 0]
        k_keep = lanes.k.index_select(0, keep)
        v_keep = lanes.v.index_select(0, keep)
        kc, vc = lanes.k, lanes.v
        first = torch.zeros_like(plen)
        for j in range(prompts.shape[1]):
            live = admit & (j < plen)
            pos = torch.where(live, j, 0).to(torch.int32)
            logits, _, kc, vc = pol.decode_step(params, prompts[:, j], kc, vc,
                                                pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            first = torch.where(admit & (j == plen - 1), nxt, first)
        kc.index_copy_(0, keep, k_keep)
        vc.index_copy_(0, keep, v_keep)
        lanes = lanes.replace(
            k=kc, v=vc,
            length=torch.where(admit, plen, lanes.length),
            last_tok=torch.where(admit, first, lanes.last_tok),
            active=admit | lanes.active,
            req_id=torch.where(admit, req_ids, lanes.req_id),
            n_new=torch.where(admit, 1, lanes.n_new).to(torch.int32),
            max_new=torch.where(admit, req_max_new, lanes.max_new),
        )
        return lanes, first

    # ------------------------------ decode -------------------------- #
    def _step_impl(self, params: Any, lanes: ServeLaneState
                   ) -> tuple[ServeLaneState, torch.Tensor, torch.Tensor]:
        """One decode step over the whole block.  Every lane computes
        (fixed shapes); only ``active`` lanes advance.  The greedy token
        is a plain argmax: the JAX package's ``_select`` also forms a
        log-softmax that XLA drops as unused, which eager PyTorch would
        run over the whole vocabulary."""
        pol = self.policy
        active = lanes.active
        pos = torch.clamp(lanes.length, max=pol.max_len - 1)
        logits, _, kc, vc = pol.decode_step(params, lanes.last_tok, lanes.k,
                                            lanes.v, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        n_new = lanes.n_new + 1
        done = active & (n_new >= lanes.max_new)
        if self.eos_token is not None:
            done = done | (active & (nxt == self.eos_token))
        done = done | (active & (pos + 1 >= pol.max_len - 1))
        lanes = lanes.replace(
            k=kc, v=vc,
            length=torch.where(active, pos + 1, lanes.length),
            last_tok=torch.where(active, nxt, lanes.last_tok),
            n_new=torch.where(active, n_new, lanes.n_new),
            active=active & ~done,
        )
        return lanes, nxt, active

    # ------------------------------ serve --------------------------- #
    def serve(self, params: Any, prompts: Sequence[Sequence[int]],
              continuous: bool = True,
              max_new: Sequence[int] | None = None,
              ) -> tuple[list[list[int]], ServeStats]:
        """Decode every request; returns (per-request token lists,
        throughput/utilization stats).  ``max_new`` optionally sets each
        request's generation budget (default: the pool's)."""
        n_req = len(prompts)
        budgets = ([self.max_new] * n_req if max_new is None
                   else [int(m) for m in max_new])
        order = list(range(n_req))
        if self.schedule == "sjf":
            order.sort(key=lambda i: len(prompts[i]) + budgets[i])
        pending = deque(order)
        P = max(len(p) for p in prompts)
        if P + max(budgets) > self.policy.max_len:
            raise ValueError(
                f"prompt_len {P} + max_new {max(budgets)} exceeds the "
                f"policy's static cache ({self.policy.max_len})")

        def dev(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(x).to(self.device)

        params = self.policy.cast_params(params)
        lanes = self.init_lanes()
        active_np = np.zeros(self.num_lanes, bool)
        outputs: list[list[int]] = [[] for _ in range(n_req)]
        steps = 0
        # the fenced span waits for the final lane state, so wall_s
        # covers the device work of the last steps
        tr = Tracer()
        with tr.span("serve") as sp:
            while pending or active_np.any():
                free = np.flatnonzero(~active_np)
                may_admit = continuous or not active_np.any()
                if pending and len(free) and may_admit:
                    admit = np.zeros(self.num_lanes, bool)
                    pr = np.zeros((self.num_lanes, P), np.int32)
                    pl = np.zeros(self.num_lanes, np.int32)
                    rid = np.full(self.num_lanes, -1, np.int32)
                    mx = np.full(self.num_lanes, self.max_new, np.int32)
                    for lane in free:
                        if not pending:
                            break
                        r = pending.popleft()
                        admit[lane] = True
                        pl[lane] = len(prompts[r])
                        pr[lane, :len(prompts[r])] = prompts[r]
                        rid[lane] = r
                        mx[lane] = budgets[r]
                    lanes, first = self._admit_impl(
                        params, lanes, dev(admit), dev(pr), dev(pl),
                        dev(rid), dev(mx))
                    first_np = first.cpu().numpy()
                    for lane in np.flatnonzero(admit):
                        outputs[int(rid[lane])].append(int(first_np[lane]))
                    # a freshly admitted lane might already be done
                    # (budget 1): retire it before the next decode step
                    lanes = lanes.replace(
                        active=lanes.active & (lanes.n_new < lanes.max_new))
                    active_np = lanes.active.cpu().numpy()
                if not active_np.any():
                    continue
                lanes, toks, emitted = self._step_impl(params, lanes)
                steps += 1
                # one device-to-host copy per step (req_id is unchanged
                # by the step)
                host = torch.stack([toks, emitted.to(torch.int32),
                                    lanes.active.to(torch.int32),
                                    lanes.req_id]).cpu().numpy()
                toks_np, em_np, rid_np = host[0], host[1] != 0, host[3]
                active_np = host[2] != 0
                for lane in np.flatnonzero(em_np):
                    outputs[int(rid_np[lane])].append(int(toks_np[lane]))
            sp.fence(lanes)
        wall = tr.totals()["serve"]
        total = sum(len(o) for o in outputs)
        stats = ServeStats(
            requests=n_req, total_tokens=total, decode_steps=steps,
            lane_slots=steps * self.num_lanes, wall_s=wall,
        )
        if self.registry is not None:
            publish_serve_stats(self.registry, stats,
                                schedule=self.schedule)
        return outputs, stats


__all__ = ["DecodePool", "ServeLaneState", "ServeStats"]
