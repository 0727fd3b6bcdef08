#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card, and check what comes out.

    python3 chip_smoke.py [--parent DIR]

Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the time to build the kernel library from
   ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, inputs made from a seed (numpy, or a
   seeded torch generator on the card for the 0.3 G-value cache):
   bitwise (``torch.equal``) for the five env and image kernels;
   decode attention within atol 2e-2 in bf16 (the main path's dtype)
   and 1e-5 in f32, its sums running in another order; flash attention
   within 2e-2 in bf16 and 3e-5 in f32, and in bf16 within
   ``BF16_EXCESS_TOL`` (per row RMS) of the rounding of the exact
   value, at the qwen3-0.6b prefill's own calls (B=4, S=8192, the
   transposed (B, S, H, D) projections), qwen3-0.6b's causal layer at
   B=1, S=4096, starcoder2-3b's sliding one as its prefill passes it
   (S=8192, window 4096), an end-aligned non-causal D=16 case, the
   hymba-1.5b and granite-moe-3b-a800m prefills' D = 64 calls and
   qwen2-vl-72b's (B=2, S=4096, 64 over 8 heads, D=128).  Each
   kernel, its plain version and, where one exists, the one PyTorch
   call that computes the same function are timed with CUDA events, the
   calls queued behind a sleep on the card so that host launch gaps
   stay out; each flash row also gives ``tflops``, the rate of the
   function's 4 * D operations per visible pair, and ``of_bound``,
   bound_ms / ms, as do the env_step, pong_render, grayscale and crop
   rows (grayscale is also checked, not timed, on a batch one byte into
   its buffer and an odd shape; crop on a window for each path of
   ``crop_plan`` and a batch one byte into its buffer).  env_step runs
   the sync Ant cell's 4096 lanes and, as a case, the async cell's
   2048; its row also carries ``launch_floor_ms``, a one-element
   ``add_`` timed alike, what one launch costs; as cases, masked mode's
   tick (4096 lanes, ``n_sub = 1``, no costs) and AntSkew-v3's depth
   (4096 lanes, ``n_sub = 21``, costs 5..21).  The decode attention
   and resize rows are also timed cold (``ms_cold``: the same call
   rotated over inputs that exceed the 50 MB L2, the 28 layer views of
   the cache and four grayscale batches, as their callers find them)
   with ``of_bound`` = bound_ms / ms_cold; their ``cases``: decode at
   the LM collect's shape (128 lanes, cache 64) with its SDPA time,
   resize of the cropped 160x160 playfield.  flash attention's
   ``gradient`` rows: under autograd the kernel's forward with the plain
   backward (``_FlashAttentionFn``) must give an output with a
   ``grad_fn`` in one launch, the output within the flash rows'
   tolerances of ``mha_reference`` (the kernel at that shape), and dq,
   dk, dv within 2e-2 (bf16) and 1e-5 (f32) of unchunked autograd
   through ``mha_reference`` (the wiring: the backward never reads the
   kernel's output), at the full-width train step's calls (B=8, S=512,
   qwen3-0.6b's heads, transposed views) in bf16 and f32, qwen3 at
   B=2, S=4096 in bf16, where the backward runs in two chunks of query
   rows, a 256 window over 1024 (starcoder2-3b's heads) and GQA 4 with
   a 64 window in f32, each timed forward and backward beside the plain
   route and SDPA's;
3. the main paths on the card, each warmed up, its kernels' launch
   counts set to 0 just before it and read just after; every kernel of
   the path must have launched:
   - the pool, through ``repro_torch.make``: Ant-v3 N=4096 sync and
     N=4096/M=2048 async (fifo), PongClassic-v5 N=1024 sync and
     N=1024/M=512 async (sjf), 100 recvs each, and PongClassic-v5
     N=1024 sync with the playfield cropped (Grayscale, Crop, Resize,
     FrameStack, RewardClip), 50 recvs; the two sync pools again with
     ``obs=False`` (no counters: the uninstrumented recv, the baseline
     of the telemetry's cost); ``engine="device-masked"`` Ant-v3
     N=4096/M=2048 (the tick ablation, 50 recvs, with its ticks per
     recv), AntSkew-v3 N=4096/M=2048 sjf and AntNorm-v3 N=4096 sync;
     actions from a numpy seed routed by ``env_id``, every async block
     of distinct ids, five more recvs under ``torch.profiler`` for the
     device time per recv; each ``obs=True`` run prints its ``stats()``
     (occupancy, ``wait_hist``, ``overdue_admits``, ...) and must keep
     the conservation laws (``served = recvs * M``, ``sum(serves) =
     served``, ``sum(wait_hist) = served``, ``stepped <= served``);
   - training, through ``repro_torch.rl.ppo.train_device``: Ant-v3
     N=4096 sync (MLP 256-128-64) and PongClassic-v5 N=1024 sync (the
     Nature-CNN, fc 512), ``PPOConfig``'s defaults (128 steps, 4 epochs
     of 4 minibatches), f32 without TF32, three iterations each: one to
     warm up, one timed (env steps/s, frames/s, ms per iteration and
     the host ms of it spent in the recvs), one under ``torch.profiler``
     (device busy, idle share, the top three kernel families); losses
     and params finite, params on the card; after each, the same run
     through ``train_pipelined`` (the update on a second CUDA stream):
     its ms per iteration beside ``train_device``'s, each iteration's
     ``rho_behavior`` (finite), peak memory, and from the profiled
     iteration's kernel events by stream the overlap share (the
     fraction of the update stream's kernel time during which a
     collect-stream kernel also ran) and the time any kernel ran, whose
     complement is the idle share;
   - the decode server: ``DecodePool.serve`` on qwen3-0.6b at full width
     (28 layers, weights from a seeded generator), 32 lanes, 64
     requests, fifo with continuous admission; then five decode steps
     of a full block under ``torch.profiler``;
   - the LM collect: the same qwen3-0.6b policy sampling on
     ``TokenRagged-v0`` N=256/M=128 sjf, vocab 151936, for 64 recvs;
   - the model-serving path through ``make_prefill_step`` /
     ``make_serve_step`` at full width, weights from a seeded generator
     on the card: qwen3-0.6b prefill B=4, S=8192 into a cache as long
     as the prompt (``attn_impl="blocked"``: 28 flash launches per
     call; ``SHAPES["prefill_32k"]`` is B=32, S=32768, cut for run time
     and cache memory), then a qwen3-0.6b serve of 8 prompts of 1024
     tokens into a 1056-long cache (the dense cached branch) and 32
     greedy tokens, then starcoder2-3b with a 4096 sliding window,
     prefill B=1, S=8192 (30 flash launches per call); granite-moe-
     3b-a800m B=4 S=4096 and hymba-1.5b B=1 S=8192 prefills (32 each)
     and serves; qwen2-vl-72b at full width and 8 of its 80 layers,
     prefill B=2 of 1024 patch embeddings (a 32 x 32 grid, Qwen2-VL's
     (t, h, w) positions) and 3072 tokens into a 4096 cache (8 flash
     launches a call), then served from a 4096 + 32 cache, 32 steps;
     whisper-large-v3 whole served (8 clips of 1500 frames, the encoder
     timed alone, a 16-token prompt into a 64 cache, 48 steps);
     xlstm-125m whole, prefill B=8 S=2048 and served 32 steps, and 32
     steps at B=1 (the ``long_500k`` cell's decode step); each with one
     call or step under ``torch.profiler``; no prefill may copy a flash
     input (``flash_attention.copies``, nor phase 4's model checks);
     each row also prints its cell in ``distributed/analytic.py``'s
     model (``cell_cost`` of its own kind, S and B: a serve step is a
     decode over its whole static cache), ``analytic_flops``,
     ``analytic_bytes``, ``bound_ms`` (the larger of the FLOPs over the
     dense bf16 peak and the bytes over 3.35 TB/s) and ``of_bound``
     (bound_ms / ms a call or step);
4. the card against the CPU: 20 recvs of PongClassic-v5 and Ant-v3 at
   N=16 (async M=8), masked Ant-v3 (M=8), AntSkew-v3 (M=8, sjf) and
   AntNorm-v3 (sync) from one key on ``cuda`` and on ``cpu``: ids,
   done, costs and ``stats()`` equal; Pong obs and reward bitwise,
   the Ant tasks' within 1e-4 (CUDA's ``cosf`` and torch's CPU ``cos``
   differ by an ulp on some inputs), AntNorm's normalized obs within
   1e-3 (its block sums run in another order).
   ``train_device`` at the CPU tests' size (PongClassic-v5 N=4 and
   Ant-v3 N=8, 8 steps, 2 iterations of 1 epoch of 2 minibatches,
   hidden (32, 32)): the actions sent equal (Ant's within 1e-4), the
   same episodes, losses within 1e-4 relative (``pg`` 1e-5 absolute),
   params within 1e-5; ``train_pipelined`` alike, its ``rho_behavior``
   within 1e-4.
   ``DecodePool.serve`` on the f32 ``lm-policy`` config (4 lanes, 8
   requests) gives identical token lists, and 16 recvs of the sampled
   LM collect on ``TokenRagged-v0`` N=16/M=8 identical actions, ids and
   dones.  ``Model.prefill`` (blocked, 64 positions filling the cache:
   one flash launch a layer where the family has attention through it)
   and 8 greedy ``decode_step``s, then one ``train_loss`` and backward,
   on the f32 smoke configs of qwen3-0.6b, sliding starcoder2-3b
   (window 32), granite-moe-3b-a800m, hymba-1.5b, xlstm-125m,
   whisper-large-v3 (its frames encoded first) and qwen2-vl-72b (its
   patch embeddings before the tokens, M-RoPE positions): identical
   tokens, logits within 1e-4, the loss within 1e-5, gradients within
   1e-4 of each leaf's largest entry.  Three ``make_train_step`` steps
   of the f32 smoke qwen3-0.6b, blocked, full and sliding (window 32
   over 64 tokens), granite-moe-3b-a800m and hymba-1.5b: losses within
   1e-5, one flash launch a layer and step on the card.

5. the host engines (``engine="thread" | "forloop" | "subprocess"``,
   each env one lane of its batched env on the card): the thread and
   forloop engines on the card against the device engine on the card,
   Ant-v3, PongClassic-v5 and PongClassic-v5 with the playfield cropped
   at N=8, 10 steps from one seed with the same actions routed by
   ``env_id``: ids, reward, done and ``stats()`` bitwise, obs bitwise
   (Ant within 1e-4), and every kernel of the path launched exactly
   once per env step (env_step, pong_render) or per recv (grayscale,
   resize, crop); the thread engine on the card against the CPU (Ant-v3
   and PongClassic-v5, N=8); then rows of env steps/s, ms per recv, the
   launches per env step and per recv, kernels and device busy a recv
   (``torch.profiler``, three recvs; the subprocess rows' kernels run in
   their workers, out of its sight) and ``stats()`` with its
   conservation laws: Ant-v3 N=32 thread (sync and M=16), forloop and
   subprocess (4 workers), on the card and on the CPU, 5 recvs each;
   PongClassic-v5 N=16 thread (sync and M=8) on the card, 3 recvs each;
   and ``train_host`` on Ant-v3 N=16 with the envs on the CPU and the
   learner on the card (16 steps, ``PPOConfig``'s 4 x 4 minibatches,
   MLP 256-128-64), two iterations, the second's four Fig. 4 buckets;
   ``train_host_pipelined`` in the same layout, three iterations, its
   actor_wait, train and other buckets a timed iteration beside
   ``train_host``'s, and again with the envs on the card (N=8, 8 steps),
   where env_step must launch.
   Each row is a JSON line with the card's name and power limit.

6. the sharded engine (``engine="device-sharded"``) on the card.  Solo,
   every shard on ``cuda:0``: Ant-v3 N=4096 at D=4 sync, M=2048 fifo
   and M=2048 hierarchical, AntSkew-v3 N=4096 M=2048 hierarchical (its
   ``overdue_admits`` in the stats), PongClassic-v5 N=1024 sync at D=2
   and AntNorm-v3 N=4096 sync at D=2, each through ``drive_pool`` with
   its collectives a recv (``EnvMesh.log``) and its kernel launches a
   recv; the first six blocks of the three sync tasks against the same
   pool at D=1 on the card, rows aligned by env id: bitwise, but
   AntNorm-v3's normalized obs within 1e-3 (its moment sums run in
   another order at each D).  Then two processes this script spawns
   (``chip_smoke.py rank <i> <port> <device> <lanes>``), joined over gloo
   on localhost and sharing the card: their Ant-v3 N=4096 D=2 sync
   stream (20 blocks, as the whole mesh holds them) and ``stats()``
   must hash the same as this process's solo D=2 run; then
   ``train_disaggregated`` with one env process (two shards) and one
   learner, ``PPOConfig``'s defaults, two iterations: ms an iteration
   and the seconds in the hand-off (``host_broadcast``, waits
   included).  A rank that fails fails the script.  Last,
   ``train_device`` over a solo D=2 Ant-v3 N=4096 pool, two iterations.

7. the LM trainer on the card: ``make_train_step`` on qwen3-0.6b at full
   width (28 layers, d_model 1024, 16 query and 8 KV heads of 128, vocab
   151936, tied embeddings, qk-norm), ``attn_impl="blocked"``, f32
   parameters, bf16 compute, AdamW, ``SyntheticSource`` batches of B=8,
   S=512, weights from a seeded generator on the card: 2 warm-up steps,
   5 timed (tokens/s, ms a step, model TFLOP/s from
   ``model_flops_per_token``, exactly 56 flash launches a step, each
   layer's forward and, at the default ``remat="full"``, its recompute
   in the backward, and no copy; peak memory), 1 under ``torch.profiler``
   (device busy, idle share, top kernel families, the plain attention
   backward's device ms by its ``record_function`` ranges; it is also
   timed alone at the step's shape); every loss and gradient leaf
   finite, the attention weights' gradients non-zero in every layer,
   every parameter changed.  Then ``python -m repro_torch.launch.train``
   on the card: ``repro``'s learning criterion at tests/test_system.py's
   flags, and 40 steps straight against 20 + restart + 20 (loss within
   rtol 1e-4, the final parameters compared bitwise).  The train step's
   row also prints its ``cell_cost`` (train S=512 B=8: forward x 4, the
   recompute's included), bound, ``of_bound`` and analytic TFLOP/s
   beside ``model_flops_per_token``'s.

8. the tooling and the examples: ``optim/compression.py::compress_tree``
   over a gradient tree of qwen3-0.6b's every parameter leaf (596M f32,
   normals from a seed on the card) with an error buffer, timed (ms,
   GB/s, its bytes bound: gradient and error read, codes, scales and
   error written) and held bitwise against the same call on the CPU on
   every leaf; the five ``examples/*_torch.py`` through their
   ``main()`` at their JAX counterparts' defaults on the card
   (``ppo_atari_torch.py`` at ``PPO_STEPS``), each output echoed and
   checked for its rate; with ``--parent DIR`` (a checkout of the parent
   commit) phase 3's Ant-v3 N=4096 and PongClassic-v5 N=1024 sync rows'
   kernels a recv beside the parent tree's own, run in a process of its
   own: no more than the parent's.

9. the model-parallel steps on a (1, 1) mesh over nccl beside the
   unsharded steps on the same weights (phase 3's prefills and serve,
   phase 7's train step, the families); ``mesh_memory``: qwen3-0.6b
   blocked, B=2 S=4096, one train step at each ``remat`` (none, full,
   dots) on the kernel path, the dry run's tracker on meta against the
   allocator's peak, flash launches and ms a step, the parameters at
   full and dots against none's (within 1e-6 of each leaf's largest
   magnitude), full's peak below none's; the dry run of ``qwen3-14b
   train_4k`` in a process of its own beside them.

Then a ``kernels`` JSON line, the card line, and the last line
``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py turns``
runs only the two training drivers in turns (``train_turns``).
Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (launch/mesh.py, from NVIDIA's data sheet at 700 W):
# HBM bytes/s, f32 ops/s outside the tensor cores, used for the 32-bit
# integer work too, and the dense bf16 tensor-core rate, the floor of
# attention's products; outside the repository this import fails
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS_BF16 as BF16_TENSOR_OPS_PER_S,
    PEAK_FLOPS_F32 as F32_OPS_PER_S,
)

SEED = 0
# f32 operations of one Ant substep in csrc/env_step.cu, counting each
# cosf as one: legs 4 x 7 + contacts 4 + thrust 12 + normal 16
# + joints 8 x 11 + torso 1 + 9 + 7 + 3 + 2 + 9 + 6 + reward 2 + 15 + 2 + 3
ENV_STEP_OPS = 207
# qwen3-0.6b serving cell: lanes, requests, prompt lengths, generation
# budgets (examples/serve_lm.py's mix: a quarter long), static cache
SERVE_LANES, SERVE_REQUESTS = 32, 64
PROMPT_LEN = (8, 32)
MAX_NEW_LONG, MAX_NEW_SHORT = 128, 32
SERVE_MAX_LEN = 161
SERVE_MODEL = "qwen3-0.6b"
# the device of phases 2 and 3
DEV = "cuda"
# the card's name and power limit (``card_line``), set by ``main``
CARD = ""
# the Pong playfield: rows 34..193 of the 210 x 160 screen
PONG_CROP = (34, 0, 160, 160)
# flash_attention's phase-2 shapes: (case, B, H, Hkv, Sq, Skv, D, causal,
# window, dtype, atol, layout); layout "bshd": q, k, v are (B, S, H, D)
# tensors seen as (B, H, S, D), as models/blocked_attention.py passes the
# projections.  The first is the kernel's main row: the qwen3-0.6b
# prefill's calls in phase 3.
FLASH_CASES = [
    ("prefill-qwen3-B4-S8192-bf16", 4, 16, 8, 8192, 8192, 128, True, 0,
     "bfloat16", 2e-2, "bshd"),
    ("a-qwen3-causal-bf16", 1, 16, 8, 4096, 4096, 128, True, 0, "bfloat16",
     2e-2, "bhsd"),
    ("a-qwen3-causal-f32", 1, 16, 8, 4096, 4096, 128, True, 0, "float32",
     3e-5, "bhsd"),
    ("b-starcoder2-window4096-bf16", 1, 24, 2, 8192, 8192, 128, True, 4096,
     "bfloat16", 2e-2, "bshd"),
    ("c-end-aligned-noncausal-d16-f32", 2, 4, 2, 100, 300, 16, False, 0,
     "float32", 3e-5, "bhsd"),
    ("prefill-hymba-B1-S8192-window1024-bf16", 1, 25, 5, 8192, 8192, 64,
     True, 1024, "bfloat16", 2e-2, "bshd"),
    ("prefill-hymba-global-B1-S8192-bf16", 1, 25, 5, 8192, 8192, 64, True,
     0, "bfloat16", 2e-2, "bshd"),
    ("prefill-granite-B4-S4096-bf16", 4, 24, 8, 4096, 4096, 64, True, 0,
     "bfloat16", 2e-2, "bshd"),
    ("prefill-qwen2-vl-B2-S4096-bf16", 2, 64, 8, 4096, 4096, 128, True, 0,
     "bfloat16", 2e-2, "bshd"),
]

# flash_attention's gradient rows in phase 2: (case, B, H, Hkv, S, D,
# causal, window, dtype, atol), q, k and v transposed views of (B, S, H,
# D) tensors; the first is the full-width train step's call of phase 7,
# the second qwen3 at S=4096, where the plain backward runs in two chunks
# of query rows (``ops.py::chunk_rows``)
FLASH_GRAD_CASES = [
    ("train-qwen3-B8-S512-bf16", 8, 16, 8, 512, 128, True, 0, "bfloat16",
     2e-2),
    ("train-qwen3-B2-S4096-bf16-chunked", 2, 16, 8, 4096, 128, True, 0,
     "bfloat16", 2e-2),
    ("train-qwen3-B8-S512-f32", 8, 16, 8, 512, 128, True, 0, "float32",
     1e-5),
    ("starcoder2-window256-S1024-bf16", 1, 24, 2, 1024, 128, True, 256,
     "bfloat16", 2e-2),
    ("gqa4-window64-S300-f32", 2, 8, 2, 300, 64, True, 64, "float32", 1e-5),
]
# phase 3's MoE and hybrid rows at full width: (arch, prefill batch,
# prefill length); each is also served as qwen3-0.6b is (8 prompts of
# 1024 tokens, cache 1056, 32 steps)
FAMILY_MODELS = [("granite-moe-3b-a800m", 4, 4096), ("hymba-1.5b", 1, 8192)]
# phase 3's qwen2-vl-72b row: VLM_LAYERS of its 80 layers at full width
# (f32 weights: ~3.5 GB a layer and 10 GB of embedding and head), a
# VLM_GRID x VLM_GRID grid of patch embeddings before VLM_TEXT tokens
VLM_LAYERS, VLM_GRID, VLM_TEXT = 8, 32, 3072
# phase 7's train step: the model at full width, B sequences of S tokens
TRAIN_MODEL, TRAIN_B, TRAIN_S = "qwen3-0.6b", 8, 512


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, trials: int = 5) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps``
    back-to-back calls, after a warm-up.  Before each trial the card
    sleeps (``torch.cuda._sleep``) for longer than the host takes to
    queue the ``reps`` calls, so the calls run back to back on the card
    and the time is the device's: without the sleep, a small kernel's
    time is the host's launch interval (its wrapper's Python and
    ``ctypes`` overhead), which moved 2x between machines.

    ``fn`` may be a list of calls on distinct inputs, taken in turn
    (``reps`` rounded up to a multiple of its length): with more bytes
    among them than the 50 MB L2 holds, each call finds its inputs cold,
    as a caller that touched other data in between does."""
    import torch

    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    reps = -(-reps // len(fns)) * len(fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # ~2e9 cycles/s at the H100's boost clock; the margin only costs wall
    # time, spent before the start event
    cycles = int(2e9 * (2.0 * reps * host_s + 1e-3))
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(reps):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def band_taps(in_size: int, out_size: int) -> int:
    """Taps of an area resize's weight rows, each row's span from its
    first to its last nonzero weight, summed over the rows."""
    from repro_torch.kernels.image.ref import resize_weights

    nz = resize_weights(in_size, out_size, "area") != 0
    return int((in_size - nz[:, ::-1].argmax(axis=1) - nz.argmax(axis=1))
               .sum())


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def env_inputs(n: int, rng, dev) -> list:
    """Ant physics inputs of ``n`` lanes on ``dev``: state, action, costs
    5..9 and reward0, as the pool gathers them."""
    import torch

    state = np.zeros((n, 28), np.float32)
    state[:, 0:2] = rng.normal(0, 1, (n, 2))
    state[:, 2] = rng.uniform(0.15, 0.9, n)
    state[:, 3:12] = rng.normal(0, 0.3, (n, 9))
    state[:, 12:20] = rng.uniform(-1.2, 1.2, (n, 8))
    state[:, 20:28] = rng.normal(0, 1.0, (n, 8))
    return [torch.from_numpy(x).to(dev) for x in (
        state, rng.uniform(-1.3, 1.3, (n, 8)).astype(np.float32),
        rng.integers(5, 10, n).astype(np.int32),
        rng.normal(0, 1, n).astype(np.float32))]


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------- #
def check_kernels() -> dict[str, dict]:
    import torch

    from repro_torch.kernels.env_step import ops as env_ops
    from repro_torch.kernels.image import ops as img_ops

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    res = {}

    def row(name, src, replaces, out, plain, nbytes, ops, run, run_plain,
            atol=None, library=None, ops_per_s=F32_OPS_PER_S, case=None,
            exact=None, cold=None, of_bound=False):
        """``atol`` None: bitwise; ``library``: one PyTorch call that
        computes the same function, timed as the yardstick; ``case``:
        a further shape of a kernel already in ``res``, kept in its
        ``cases``; ``exact``: the f32 values of a bf16 output, which
        must lie within ``BF16_EXCESS_TOL`` of their rounding; ``cold``:
        the same call on distinct inputs that together exceed the L2,
        timed in turn as ``ms_cold``, with ``of_bound`` = bound_ms /
        ms_cold; else ``of_bound`` True gives ``of_bound`` = bound_ms /
        ms."""
        from repro_torch.kernels.flash_attention.ref import (
            BF16_EXCESS_TOL, rounding_excess)

        err = max((float((a.float() - b.float()).abs().max())
                   if a.numel() else 0.0) for a, b in zip(out, plain))
        if atol is None:
            ok = all(torch.equal(a, b) for a, b in zip(out, plain))
        else:
            ok = err <= atol
        if not ok:
            raise AssertionError(f"{name} {case or ''}: kernel != plain "
                                 f"version, max abs err {err}, tolerance "
                                 f"{atol}")
        excess = None
        if exact is not None:
            excess = max(rounding_excess(a, e) for a, e in zip(out, exact))
            if excess > BF16_EXCESS_TOL:
                raise AssertionError(
                    f"{name} {case or ''}: {excess} row RMS beyond the bf16 "
                    f"rounding of the exact value, tolerance "
                    f"{BF16_EXCESS_TOL}")
        b_ms, b_by = bound(nbytes, ops, ops_per_s)
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(run), "plain_ms": time_ms(run_plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library),
        }
        if excess is not None:
            entry["rounding_excess"] = excess
        if cold is not None:
            entry["ms_cold"] = time_ms(cold)
            entry["of_bound"] = b_ms / entry["ms_cold"]
        elif of_bound:
            entry["of_bound"] = b_ms / entry["ms"]
        if case is None:
            res[name] = entry
        else:
            res[name].setdefault("cases", []).append(
                {"case": case, **{k: v for k, v in entry.items() if k in (
                    "max_abs_err", "rounding_excess", "ms", "ms_cold",
                    "of_bound", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
        log(f"  {name} {case or ''}: "
            f"{'bitwise equal' if atol is None else f'within {atol}'}"
            f" (max abs err {err}"
            f"{'' if excess is None else f', rounding excess {excess}'})"
            f"; kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, library "
            f"{entry['library_ms']} ms, bound {b_ms:.4f} ms ({b_by})"
            + ("" if cold is None else
               f"; cold {entry['ms_cold']:.4f} ms")
            + ("" if "of_bound" not in entry else
               f", {entry['of_bound']:.3f} of its bound"))
        return res[name] if case is None else res[name]["cases"][-1]

    # env_step: Ant N = 4096, costs 5..9 (main path: state gathered from
    # the pool, n_sub = max_cost = 9); the async cell's 2048 lanes as a
    # case, from their own seed; beside them what one launch costs
    for case, n, gen in ((None, 4096, rng),
                         ("async-2048", 2048,
                          np.random.default_rng(SEED + 1))):
        s, a, c, r0 = env_inputs(n, gen, dev)

        def run(s=s, a=a, c=c, r0=r0):
            return env_ops.env_multi_step(s, a, c, r0, n_sub=9)

        def run_plain(s=s, a=a, c=c, r0=r0):
            return env_ops.env_multi_step(s, a, c, r0, n_sub=9,
                                          backend="reference")

        row("env_step", "src/repro_torch/csrc/env_step.cu",
            "src/repro/kernels/env_step/kernel.py:103", run(), run_plain(),
            nbytes=n * (28 * 4 * 2 + 8 * 4 + 4 + 4 + 4),
            ops=ENV_STEP_OPS * float(c.sum()), run=run, run_plain=run_plain,
            case=case, of_bound=True)
    # the masked tick (n_sub = 1, no costs: every lane one substep) and
    # AntSkew-v3's depth (n_sub = 21, costs 5..21), 4096 lanes each
    for case, n_sub, lo in (("tick-4096", 1, None), ("skew-4096", 21, 5)):
        gen = np.random.default_rng(SEED + 1 + n_sub)
        s, a, _, r0 = env_inputs(4096, gen, dev)
        c = None if lo is None else torch.from_numpy(gen.integers(
            lo, n_sub + 1, 4096).astype(np.int32)).to(dev)

        def run(s=s, a=a, c=c, r0=r0, n_sub=n_sub):
            return env_ops.env_multi_step(s, a, c, r0, n_sub=n_sub)

        def run_plain(s=s, a=a, c=c, r0=r0, n_sub=n_sub):
            return env_ops.env_multi_step(s, a, c, r0, n_sub=n_sub,
                                          backend="reference")

        substeps = 4096 * n_sub if c is None else float(c.sum())
        row("env_step", "src/repro_torch/csrc/env_step.cu",
            "src/repro/kernels/env_step/kernel.py:103", run(), run_plain(),
            nbytes=4096 * (28 * 4 * 2 + 8 * 4 + 4 + 4)
            + (0 if c is None else 4096 * 4),
            ops=ENV_STEP_OPS * substeps, run=run, run_plain=run_plain,
            case=case, of_bound=True)
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1.0))
    res["env_step"]["launch_floor_ms"] = floor
    for c in res["env_step"]["cases"]:
        c["launch_floor_ms"] = floor
    log(f"  launch floor (a one-element add_): {floor:.4f} ms")

    # pong_render: PongClassic N = 1024 (sync block); ball positions
    # include whole and half grid values, where compares sit on an edge,
    # and the ball on, at and beyond the edges and the paddles
    n = 1024
    pos = rng.uniform(0, 84, (4, n)).astype(np.float32)
    pos[:, : n // 4] = np.round(pos[:, : n // 4] * 2) / 2
    pos[:, :6] = np.array([(0, 0, 0, 84), (84, 84, 84, 0), (-3, 90, 42, 42),
                           (82.5, 40, 40, 10), (1, 20, 60, 20),
                           (90, -3, 0.5, 83.5)], np.float32).T
    bx, by, py, ey = (torch.from_numpy(p).to(dev) for p in pos)
    rgb = img_ops.pong_render(bx, by, py, ey)

    def run():
        return img_ops.pong_render(bx, by, py, ey)

    def run_plain():
        return img_ops.pong_render(bx, by, py, ey, backend="reference")

    # the bound's operations: the plain version's 20 a pixel (the kernel
    # tests a row or a column once, far fewer); the bytes bind it anyway
    row("pong_render", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:167", [rgb], [run_plain()],
        nbytes=n * 16 + rgb.numel(), ops=rgb.numel() // 3 * 20.0,
        run=run, run_plain=run_plain, of_bound=True)

    # grayscale: the main path feeds it the render; random bytes cover
    # every input value; a batch one byte into its buffer and an odd
    # shape take the byte path (checked, not timed)
    img = torch.from_numpy(rng.integers(0, 256, (n, 210, 160, 3),
                                        dtype=np.uint8)).to(dev)
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 64 * 210 * 160 * 3,
                                         dtype=np.uint8)).to(dev)
    for case, x in (("render", rgb), ("random", img),
                    ("unaligned", flat[1:].view(64, 210, 160, 3)),
                    ("odd", img[:3, :7, :5].contiguous())):
        if not torch.equal(img_ops.grayscale(x),
                           img_ops.grayscale(x, backend="reference")):
            raise AssertionError(f"grayscale {case}: kernel != plain "
                                 "version")
    del flat

    def run():
        return img_ops.grayscale(img)

    def run_plain():
        return img_ops.grayscale(img, backend="reference")

    row("grayscale", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:63", [run()], [run_plain()],
        nbytes=img.numel() * 4 // 3, ops=img.numel() // 3 * 7.0,
        run=run, run_plain=run_plain, of_bound=True)

    # resize: 210x160 -> 84x84 area (main path), plus bilinear and a size
    # that does not divide, checked but not timed; timed warm on one batch
    # and cold in turn over four (138 MB); then the cropped playfield
    gray = img_ops.grayscale(img)
    for h, w, oh, ow, method in ((210, 160, 84, 84, "bilinear"),
                                 (37, 29, 11, 17, "area")):
        x = gray[:64, :h, :w].contiguous()
        if not torch.equal(img_ops.resize(x, oh, ow, method),
                           img_ops.resize(x, oh, ow, method,
                                          backend="reference")):
            raise AssertionError(f"resize {h}x{w}->{oh}x{ow} {method}: "
                                 "kernel != plain version")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    grays = [gray] + [torch.randint(0, 256, gray.shape, generator=gen,
                                    dtype=torch.uint8, device=dev)
                      for _ in range(3)]
    top, left, ch, cw = PONG_CROP
    for case, batches in ((None, grays),
                          ("cropped-160x160", [
                              img_ops.crop(g, *PONG_CROP) for g in grays])):
        x = batches[0]

        def run(x=x):
            return img_ops.resize(x, 84, 84)

        def run_plain(x=x):
            return img_ops.resize(x, 84, 84, backend="reference")

        h, w = x.shape[-2:]
        taps = w * band_taps(h, 84) + 84 * band_taps(w, 84)
        row("resize", "src/repro_torch/csrc/image.cu",
            "src/repro/kernels/image/kernel.py:98", [run()], [run_plain()],
            nbytes=x.numel() + n * 84 * 84, ops=n * 2.0 * taps,
            run=run, run_plain=run_plain, case=case,
            cold=[lambda b=b: img_ops.resize(b, 84, 84) for b in batches])
    del grays, batches

    # crop: the Pong playfield of the grayscale screens (main path, path
    # (a) of img_ops.crop_plan), plus a window for each other path and a
    # batch one byte into its buffer (the byte path), checked, not timed
    x = gray[:64].contiguous()
    flat = torch.empty(1 + x.numel(), dtype=torch.uint8, device=dev)
    flat[1:] = x.view(-1)
    for case, img, window, path in (
            ("runs", x, PONG_CROP, img_ops.CROP_RUNS),
            ("spans", x, (3, 16, 101, 32), img_ops.CROP_SPANS),
            ("words", x, (3, 4, 101, 36), img_ops.CROP_WORDS),
            ("bytes", x, (3, 5, 101, 37), img_ops.CROP_BYTES),
            ("unaligned", flat[1:].view(x.shape), PONG_CROP,
             img_ops.CROP_BYTES)):
        got = img_ops.crop(img, *window)
        planned = img_ops.crop_plan(img.data_ptr(), got.data_ptr(),
                                    *img.shape[-2:], *window)
        if planned != path or not torch.equal(
                got, img_ops.crop(img, *window, backend="reference")):
            raise AssertionError(f"crop {case} {window}: path {planned} "
                                 f"(want {path}), or kernel != plain "
                                 "version")
    del flat

    def run():
        return img_ops.crop(gray, *PONG_CROP)

    def run_plain():
        return img_ops.crop(gray, *PONG_CROP, backend="reference")

    def library():
        return gray[:, top:top + ch, left:left + cw].contiguous()

    row("crop", "src/repro_torch/csrc/image.cu",
        "src/repro/kernels/image/kernel.py:129", [run()], [run_plain()],
        nbytes=2 * n * ch * cw, ops=0.0, run=run, run_plain=run_plain,
        library=library, of_bound=True)
    res.update(check_decode_attention(rng, row))
    check_flash_attention(row)
    check_flash_gradient(res["flash_attention"])
    return res


def check_decode_attention(rng, row) -> dict:
    """decode_attention at the serve cell's shapes: 32 lanes, qwen3-0.6b
    heads (16 query, 8 kv, D 128), a 161-position cache in bf16 passed
    as layer 5 of a (B, 28, 8, T, 128) cache, ragged lengths with 0, 1
    and T.  f32 is checked at the same shapes, bf16 is timed: warm on
    layer 5, and cold in turn over the 28 layer views, as a decode step
    reads them (0.29 GB of valid rows).  Then the LM collect's shape as a
    case: 128 lanes, a 64-position cache (``LMPolicy``'s default
    ``max_len``).  The library yardstick is SDPA with GQA and a boolean
    length mask (it gives NaN, not 0, for the length-0 lane; only its
    time is used)."""
    import torch

    def ragged(B, T):
        lengths = rng.integers(0, T + 1, B).astype(np.int32)
        lengths[:3] = (0, 1, T)
        return lengths

    res = {}
    serve = ragged(SERVE_LANES, SERVE_MAX_LEN)
    for dtype in (torch.float32, torch.bfloat16):
        decode_row(row, res, None, SERVE_LANES, SERVE_MAX_LEN, dtype, serve)
    decode_row(row, res, "collect-B128-T64-bf16", 128, 64, torch.bfloat16,
               ragged(128, 64))
    return res


def decode_row(row, res, case, B, T, dtype, lengths_np) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention

    dev = torch.device("cuda")
    H, Hkv, D, L = 16, 8, 128, 28
    lengths = torch.from_numpy(lengths_np).to(dev)
    # up to 0.3 G values: drawn on the card from a seeded generator
    gen = torch.Generator(device=dev).manual_seed(SEED + B)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    cache = torch.randn((2, B, L, Hkv, T, D), generator=gen,
                        device=dev).to(dtype)
    k, v = cache[0][:, 5], cache[1][:, 5]
    atol = 1e-5 if dtype == torch.float32 else 2e-2

    def run():
        return decode_attention(q, k, v, lengths)

    def run_plain():
        return decode_attention(q, k, v, lengths, backend="reference")

    if dtype == torch.float32:
        err = float((run() - run_plain()).abs().max())
        if err > atol:
            raise AssertionError(f"decode_attention f32: max abs err "
                                 f"{err} > {atol}")
        log(f"  decode_attention f32: within {atol} (max abs err {err})")
        return
    q4 = q[:, :, None, :]
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)

    try:
        library()
    except (TypeError, RuntimeError) as e:   # a torch without GQA SDPA
        log(f"  decode_attention: no SDPA yardstick ({e})")
        library = None

    valid = int(lengths_np.sum())
    row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:56", [run()],
        [run_plain()],
        nbytes=2 * (2 * B * H * D + 2 * valid * Hkv * D) + 4 * B,
        ops=4.0 * valid * H * D, run=run, run_plain=run_plain,
        atol=atol, library=library, case=case,
        cold=[lambda i=i: decode_attention(q, cache[0][:, i],
                                           cache[1][:, i], lengths)
              for i in range(L)])
    del cache
    torch.cuda.empty_cache()


def check_flash_attention(row) -> None:
    """flash_attention against ``mha_reference`` on the card at
    ``FLASH_CASES``, inputs from a seeded generator on the card:

    the main row: the qwen3-0.6b prefill's calls of phase 3, B=4,
        S=8192, H=16, Hkv=8, D=128, causal, bf16, q, k and v transposed
        views of (B, S, H, D) tensors; SDPA with ``is_causal`` as the
        yardstick;
    (a) qwen3-0.6b's layer: B=1, S=4096, dense (B, H, S, D), bf16 and
        f32; SDPA with ``is_causal``;
    (b) starcoder2-3b's with its 4096 window, as its prefill passes it:
        B=1, H=24, Hkv=2, S=8192, D=128, bf16, transposed views; SDPA
        with a boolean band mask;
    (c) Sq=100 end-aligned against Skv=300, non-causal, D=16, f32; SDPA
        without a mask (alignment does not matter then);
    (d) hymba-1.5b's prefill calls of phase 3, B=1, S=8192, H=25 over
        Hkv=5 (a GQA group of 5), D=64, bf16, transposed views: its 1024
        window (29 of its 32 layers; SDPA with a band mask) and causal
        (layers 0, 15, 31);
    (e) granite-moe-3b-a800m's, B=4, S=4096, H=24, Hkv=8, D=64, causal,
        bf16, transposed views;
    (f) qwen2-vl-72b's prefill calls of phase 3, B=2, S=4096 (1024
        patch positions and 3072 of text), H=64 over Hkv=8, D=128,
        causal, bf16, transposed views.

    bf16 within 2e-2 of the plain version and within ``BF16_EXCESS_TOL``
    of the rounding of the exact value (``mha_reference`` on f32 copies),
    f32 within 3e-5, the tolerance of tests/test_kernels.py.  The plain
    version runs one batch element at a time, which bounds its f32
    scores to 4.3 GB at the main row.  Each is timed.  The bound is the
    larger of the bytes over the HBM rate and 4 * D * visible pairs * H
    * B operations over the bf16 tensor peak (the f32 case over the f32
    peak: TF32 is off)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         mha_reference,
                                                         visible_pairs)

    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    src = "src/repro_torch/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention/kernel.py:86"
    for n, (case, B, H, Hkv, Sq, Skv, D, causal, window, dtype, atol,
            layout) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dtype)

        def draw(heads, seq):
            if layout == "bshd":
                return torch.randn((B, seq, heads, D), generator=gen,
                                   device=DEV).to(dtype).transpose(1, 2)
            return torch.randn((B, heads, seq, D), generator=gen,
                               device=DEV).to(dtype)

        q, k, v = draw(H, Sq), draw(Hkv, Skv), draw(Hkv, Skv)

        def run():
            return flash_attention(q, k, v, causal=causal, window=window)

        def per_batch(fn):
            return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1])
                              for b in range(B)])

        def run_plain():
            return per_batch(lambda q, k, v: flash_attention(
                q, k, v, causal=causal, window=window, backend="reference"))

        exact = None
        if dtype == torch.bfloat16:
            exact = [per_batch(lambda q, k, v: mha_reference(
                q.float(), k.float(), v.float(), causal=causal,
                window=window))]
        library = None
        if not causal and not window:
            def library():
                return F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True)
        elif Sq == Skv:             # SDPA's causal mask is top-left aligned
            if window:
                pos = torch.arange(Sq, device=DEV)
                band = (pos[None, :] <= pos[:, None]) & (
                    pos[None, :] > pos[:, None] - window)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=band, enable_gqa=True)
            else:
                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
        if library is not None:
            try:
                library()
            except (TypeError, RuntimeError) as e:   # no GQA SDPA
                log(f"  flash_attention {case}: no SDPA yardstick ({e})")
                library = None
        el = q.element_size()
        pairs = visible_pairs(Sq, Skv, causal, window)
        peak = (BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16
                else F32_OPS_PER_S)
        ops = 4.0 * D * pairs * H * B
        entry = row("flash_attention", src, replaces, [run()],
                    [run_plain()],
                    nbytes=el * (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D),
                    ops=ops, run=run, run_plain=run_plain, atol=atol,
                    library=library, ops_per_s=peak,
                    case=None if n == 0 else case, exact=exact)
        entry["tflops"] = ops / entry["ms"] * 1e-9
        entry["of_bound"] = entry["bound_ms"] / entry["ms"]
        log(f"  flash_attention {case}: {entry['tflops']:.1f} TFLOP/s of "
            f"the function's 4*D operations a pair, {entry['of_bound']:.3f} "
            "of its bound")
        del q, k, v, exact
        torch.cuda.empty_cache()


def check_flash_gradient(entry: dict) -> None:
    """flash_attention under autograd at ``FLASH_GRAD_CASES``, inputs from
    a seeded generator on the card: the kernel's forward with the plain
    backward (``ops.py::_FlashAttentionFn``) must return an output with a
    ``grad_fn``, launch the kernel once, and give dq, dk, dv within 2e-2
    (bf16) or 1e-5 (f32) of autograd through ``mha_reference``.  The
    backward recomputes the plain version and never reads the kernel's
    output, so the gradients check the wiring; the kernel itself is held
    at each shape by its output, against ``mha_reference`` as in
    ``check_flash_attention`` (2e-2 and ``BF16_EXCESS_TOL`` of the
    rounding of the exact value in bf16, 3e-5 in f32).  Where the
    backward runs in chunks of query rows (``chunk_rows``), the unchunked
    autograd is the reference.  Each route is timed forward and
    backward, the kernel's, the plain version's and SDPA's (with GQA;
    a boolean band mask for a window).  The bound: q, k, v and the output
    gradient read, the output, dq, dk and dv written, over the HBM rate,
    and 12 * D operations a visible pair (4 forward, 8 backward) over the
    peak.  The rows go into ``entry["gradient"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (chunk_rows,
                                                         flash_attention,
                                                         mha_reference,
                                                         visible_pairs)
    from repro_torch.kernels.flash_attention.ref import (BF16_EXCESS_TOL,
                                                         rounding_excess)

    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    rows = []
    for case, B, H, Hkv, S, D, causal, window, dtype, atol in \
            FLASH_GRAD_CASES:
        dtype = getattr(torch, dtype)

        def draw(heads):
            return torch.randn((B, S, heads, D), generator=gen,
                               device=DEV).to(dtype).transpose(
                                   1, 2).requires_grad_()

        q, k, v = draw(H), draw(Hkv), draw(Hkv)
        dout = torch.randn((B, H, S, D), generator=gen, device=DEV).to(dtype)
        masks = dict(causal=causal, window=window)

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), dout)

        before = flash_attention.launches
        out = flash_attention(q, k, v, **masks)
        if out.grad_fn is None:
            raise AssertionError(f"flash_attention {case}: no grad_fn "
                                 "under autograd")
        got = torch.autograd.grad(out, (q, k, v), dout)
        if flash_attention.launches != before + 1:
            raise AssertionError(
                f"flash_attention gradient {case}: "
                f"{flash_attention.launches - before} launches, not 1")
        with torch.no_grad():
            fwd_err = float((out.float() - mha_reference(
                q, k, v, **masks).float()).abs().max())
            fwd_atol, excess = 3e-5, None
            if dtype == torch.bfloat16:
                fwd_atol = 2e-2
                excess = rounding_excess(out, mha_reference(
                    q.float(), k.float(), v.float(), **masks))
        if fwd_err > fwd_atol or (excess is not None
                                  and excess > BF16_EXCESS_TOL):
            raise AssertionError(
                f"flash_attention gradient {case}: forward max abs err "
                f"{fwd_err} (tolerance {fwd_atol}), rounding excess "
                f"{excess} (tolerance {BF16_EXCESS_TOL})")
        chunks = -(-S // chunk_rows(B, H, S, S, causal))
        if case.endswith("-chunked") != (chunks > 1):
            raise AssertionError(f"flash_attention gradient {case}: the "
                                 f"backward runs in {chunks} chunk(s)")
        run_plain = fwd_bwd(lambda q, k, v: mha_reference(q, k, v, **masks))
        want = run_plain()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        if err > atol or not all(bool(torch.isfinite(g).all())
                                 for g in got):
            raise AssertionError(f"flash_attention gradient {case}: max abs "
                                 f"err {err}, tolerance {atol}")
        mask = None
        if window:
            pos = torch.arange(S, device=DEV)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        library = fwd_bwd(sdpa)
        try:
            library()
        except (TypeError, RuntimeError) as e:       # no GQA SDPA
            log(f"  flash_attention gradient {case}: no SDPA yardstick "
                f"({e})")
            library = None
        pairs = visible_pairs(S, S, causal, window)
        b_ms, b_by = bound(
            q.element_size() * (4 * B * H * S * D + 4 * B * Hkv * S * D),
            12.0 * D * pairs * H * B,
            BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16
            else F32_OPS_PER_S)
        row = {"case": case, "max_abs_err": err,
               "forward_max_abs_err": fwd_err, "rounding_excess": excess,
               "chunks": chunks,
               "ms": time_ms(fwd_bwd(lambda q, k, v: flash_attention(
                   q, k, v, **masks)), reps=5, trials=3),
               "plain_ms": time_ms(run_plain, reps=3, trials=3),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if library is None
               else time_ms(library, reps=5, trials=3)}
        rows.append(row)
        log(f"  flash_attention gradient {case}: within {atol} (max abs err "
            f"{err}; forward {fwd_err}, rounding excess {excess}; "
            f"{chunks} chunk(s)); kernel forward + plain backward "
            f"{row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']} "
            f"ms, bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, dout, out, got, want
    entry["gradient"] = rows
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# phase 3: the pool on the card
# ---------------------------------------------------------------------- #
def counters() -> dict:
    from repro_torch.kernels.backend import kernel_ops

    return kernel_ops()


def reset_counts() -> None:
    from repro_torch.kernels.backend import reset_launches

    reset_launches(counters().values())


def read_counts(tag: str, path: tuple[str, ...]) -> dict:
    launches = {k: fn.launches for k, fn in counters().items()}
    for k in path:
        if launches[k] == 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")
    return launches


def action_tables(pool, count: int, rng) -> list:
    import torch

    act = pool.spec.act_spec
    shape = (count, pool.num_envs) + act.shape
    if act.dtype.is_floating_point:
        tabs = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    else:
        tabs = rng.integers(0, int(act.maximum) + 1, shape).astype(np.int32)
    return list(torch.from_numpy(tabs).to(pool.device))


def kernel_family(name: str) -> str:
    """A CUDA kernel's name without its template and argument lists,
    plus the op it applies where PyTorch names one (its functor or
    ``*_kernel_cuda``), e.g. ``vectorized_elementwise_kernel[BitwiseAnd
    Functor]``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    ops = re.findall(r"\w*Functor\w*|\w+_kernel_cuda", name)
    return f"{base}[{ops[-1]}]" if ops else base


def user_annotation(event) -> bool:
    """Whether a kineto event is a ``record_function`` range (on the
    card's timeline it spans the kernels launched inside it, so it is no
    kernel of its own)."""
    return bool(getattr(event, "is_user_annotation", lambda: False)())


def device_summary(prof, count: int, unit: str) -> dict:
    """What ``prof`` (a stopped ``torch.profiler.profile``) saw on the
    card, per ``unit`` over ``count`` units: the sum of CUDA kernel
    durations, kernels, and the six kernel families with the most time.
    All None when the profiler saw no device activity.  It reads the raw
    kineto events: building ``prof.events()`` for a training
    iteration's half a million kernels took 154 s."""
    from torch.autograd import DeviceType

    kernels = [(e.name(), e.duration_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not user_annotation(e)]
    keys = (f"device_busy_ms_per_{unit}", f"kernels_per_{unit}",
            f"top_kernels_ms_per_{unit}")
    if not kernels:
        return dict.fromkeys(keys)
    by_family: dict[str, float] = {}
    for name, us in kernels:
        fam = kernel_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + us
    top = sorted(by_family.items(), key=lambda kv: -kv[1])[:6]
    return dict(zip(keys, (sum(by_family.values()) / 1e3 / count,
                           len(kernels) / count,
                           {k: v / 1e3 / count for k, v in top})))


def profile_device(fn, count: int, unit: str = "recv") -> dict:
    """``device_summary`` of ``count`` calls of ``fn`` under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    return device_summary(prof, count, unit)


def profile_recvs(pool, ps, ts, tables, recvs: int = 5) -> dict:
    """``profile_device`` over ``recvs`` more recvs of ``pool``."""
    state = [ps, ts, 0]

    def recv():
        ps, ts, t = state
        state[:] = pool.step(ps, tables[t % 8][ts.env_id.long()],
                             ts.env_id) + (t + 1,)

    return profile_device(recv, recvs)


def check_stats(tag: str, stats: dict, m: int) -> None:
    """The conservation laws of ``pool.stats()``."""
    laws = {
        "served = recvs * M": stats["served"] == stats["recvs"] * m,
        "sum(serves) = served": int(stats["serves"].sum()) == stats["served"],
        "sum(wait_hist) = served":
            int(stats["wait_hist"].sum()) == stats["served"],
        "0 <= stepped <= served": 0 <= stats["stepped"] <= stats["served"],
    }
    broken = [k for k, ok in laws.items() if not ok]
    if broken:
        raise AssertionError(f"{tag}: stats() breaks {broken}")


def drive_pool(task: str, n: int, m: int | None, schedule: str,
               path: tuple[str, ...], recvs: int = 100,
               transforms=None, obs: bool = True,
               engine: str = "device", shards: int | None = None) -> dict:
    """``recvs`` timed recvs of ``task`` after ten of warm-up, then five
    under ``torch.profiler``; ``shards``: the sharded engine on the card,
    whose collectives a recv are counted too."""
    import torch

    import repro_torch

    if shards is not None:
        engine = "device-sharded"
    pool = repro_torch.make(task, num_envs=n, batch_size=m,
                            schedule=schedule, transforms=transforms,
                            obs=obs, engine=engine, num_shards=shards,
                            device=DEV)
    tables = action_tables(pool, 8, np.random.default_rng(SEED))
    ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
    for t in range(10):
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
    torch.cuda.synchronize()

    mesh = getattr(pool, "mesh", None)
    if mesh is not None:
        mesh.reset_log()
    reset_counts()
    ticks0 = pool.masked_ticks
    ids, costs = [], []
    t0 = time.perf_counter()
    for t in range(recvs):
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
        ids.append(ts.env_id)
        costs.append(ts.step_cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(task, path)
    collectives = None if mesh is None else {
        k: v / recvs for k, v in mesh.counts().items()}
    collective_bytes = None if mesh is None else sum(
        b for _, b in mesh.log) / recvs
    ticks = pool.masked_ticks - ticks0
    ids = torch.stack(ids)
    block = pool.batch_size
    srt = ids.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{task}: a block holds a repeated env_id")
    last = ts.obs
    want = (block,) + pool.spec.obs_spec.shape
    if tuple(last.shape) != want or last.dtype != pool.spec.obs_spec.dtype:
        raise AssertionError(f"{task}: obs {tuple(last.shape)} "
                             f"{last.dtype}, want {want}")
    if last.dtype.is_floating_point and not bool(
            torch.isfinite(last).all()):
        raise AssertionError(f"{task}: non-finite obs")
    steps = recvs * block
    frames = int(torch.stack(costs).sum())
    out = {"task": task, "num_envs": n, "batch_size": block,
           "engine": engine, "obs": obs,
           "transforms": [t.name for t in pool.pipeline.transforms],
           "schedule": schedule, "recvs": recvs, "seconds": dt,
           "env_steps_per_s": steps / dt, "frames_per_s": frames / dt,
           "ms_per_recv": dt / recvs * 1e3, "launches": launches}
    if mesh is not None:
        out.update(num_shards=pool.num_shards,
                   collectives_per_recv=collectives,
                   collective_bytes_per_recv=collective_bytes,
                   kernel_launches_per_recv={
                       k: v / recvs for k, v in launches.items() if v})
    if engine == "device-masked":
        out["ticks_per_recv"] = ticks / recvs
    if obs:
        stats = pool.stats(ps)
        check_stats(task, stats, block)
        out["stats"] = {k: stats[k] for k in (
            "recvs", "served", "stepped", "occupancy", "cost_sum",
            "overdue_admits", "wait_ticks_total")}
        out["stats"]["wait_hist"] = stats["wait_hist"].tolist()
    out.update(profile_recvs(pool, ps, ts, tables))
    busy = out["device_busy_ms_per_recv"]
    out["device_idle_share"] = (None if busy is None
                                else 1.0 - busy / out["ms_per_recv"])
    log(f"  {task} N={n} M={block} {engine} {schedule} obs={obs} "
        + (f"D={pool.num_shards} collectives/recv {collectives} "
           f"({collective_bytes:.0f} bytes) " if mesh is not None else "")
        + f"{out['transforms']}: "
        f"{out['env_steps_per_s']:.0f} env steps/s, "
        f"{out['frames_per_s']:.0f} frames/s, "
        f"{out['ms_per_recv']:.2f} ms/recv, device busy {busy} ms/recv, "
        f"launches {launches}"
        + (f", {out['ticks_per_recv']:.2f} ticks/recv"
           if "ticks_per_recv" in out else "")
        + (f"; stats {out['stats']}" if obs else ""))
    return out


def stream_overlap(prof, path: tuple[str, ...]) -> dict:
    """The profiler's kernel events by CUDA stream: the collect stream is
    the one that ran the path's kernels (``<name>_kernel``), every other
    stream with kernels counts as the update's (cuDNN runs some of the
    update's convolution kernels on streams of its own, so a run with
    both halves on one stream still shows a small share: the baseline,
    ``train_turns``'s one-stream rows).  Returns the kernel ms on each,
    the ms during which any kernel ran (``device_union_ms``) and
    ``overlap_share``, the fraction of the update streams' kernel time
    during which a collect-stream kernel also ran (None with one
    stream)."""
    import bisect

    from torch.autograd import DeviceType

    by_stream: dict[int, list[tuple[int, int]]] = {}
    collect_ids = set()
    marks = tuple(f"{k}_kernel" for k in path)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0 \
                or user_annotation(e):
            continue
        sid = e.device_resource_id()
        by_stream.setdefault(sid, []).append((e.start_ns(), e.end_ns()))
        if any(m in e.name() for m in marks):
            collect_ids.add(sid)

    def merged(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    every = merged([s for spans in by_stream.values() for s in spans])
    collect = merged([s for sid in collect_ids for s in by_stream[sid]])
    update = [s for sid, spans in by_stream.items() if sid not in collect_ids
              for s in spans]
    starts = [a for a, _ in collect]
    covered = 0
    for a, b in update:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(collect) and collect[i][0] < b:
            covered += max(0, min(b, collect[i][1]) - max(a, collect[i][0]))
            i += 1
    update_ns = sum(b - a for a, b in update)
    return {"collect_stream_kernel_ms":
            sum(b - a for sid in collect_ids
                for a, b in by_stream[sid]) / 1e6,
            "update_stream_kernel_ms": update_ns / 1e6,
            "streams": len(by_stream),
            "device_union_ms": sum(b - a for a, b in every) / 1e6,
            "overlap_share": covered / update_ns if update_ns else None}


def host_api(prof) -> dict:
    """The CUDA runtime calls ``prof`` saw on the host: the kernel
    launches' count, summed and longest ms (a launch blocks once the
    card's queue of pending work is full), and the ms spent in
    ``*Synchronize`` calls."""
    from torch.autograd import DeviceType

    launch, sync = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if "LaunchKernel" in name:
            launch.append(e.duration_ns())
        elif "Synchronize" in name:
            sync.append(e.duration_ns())
    return {"launch_api_calls": len(launch),
            "launch_api_ms": sum(launch) / 1e6,
            "launch_api_max_ms": max(launch, default=0) / 1e6,
            "sync_api_ms": sum(sync) / 1e6}


def drive_train(task: str, n: int, num_steps: int, path: tuple[str, ...],
                beside: dict | None = None) -> dict:
    """``train_device`` on ``task`` N=n sync with ``PPOConfig``'s defaults
    (4 epochs of 4 minibatches) at ``num_steps``, the nets at their
    published widths (Ant: MLP 256-128-64; Pong: the Nature-CNN, fc 512),
    f32 without TF32, for three iterations: the first warms up, the
    second is timed, the third runs under ``torch.profiler``.  The
    launch counts cover the whole call.

    With ``beside``, a ``train_device`` row of the same task, it runs
    ``train_pipelined`` instead and adds each
    iteration's ``rho_behavior`` (finite), the ms per iteration against
    ``beside``'s, and what ``stream_overlap`` reads off the profiled
    iteration: the overlap share of the update stream's kernel time and
    the device time during which any kernel ran, from which its idle
    share comes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.core.xla_loop import frames_per_batch
    from repro_torch.rl.ppo import PPOConfig, train_device, train_pipelined
    from repro_torch.utils.tree import tree_leaves

    from repro_torch.rl import ppo

    driver = train_device if beside is None else train_pipelined
    name = driver.__name__
    # host seconds from the update's call to its return, an iteration:
    # its dispatch, and any wait for the card while it dispatches
    maker = "make_ppo_update" if beside is None else "make_vtrace_ppo_update"
    make_update = getattr(ppo, maker)
    update_s = []

    def timed_maker(*args, **kwargs):
        opt, update = make_update(*args, **kwargs)

        def timed_update(*a, **kw):
            t = time.perf_counter()
            out = update(*a, **kw)
            update_s.append(time.perf_counter() - t)
            return out

        return opt, timed_update

    pool = repro_torch.make(task, num_envs=n)
    iters = 3
    cfg = PPOConfig(total_steps=iters * num_steps * n, num_steps=num_steps)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ends = []
    # host seconds spent inside pool.step (the recvs) in each iteration
    recv_s = [0.0]
    step = pool.step

    def timed_step(ps, actions, env_ids):
        t = time.perf_counter()
        out = step(ps, actions, env_ids)
        recv_s[-1] += time.perf_counter() - t
        return out

    pool.step = timed_step

    def log_fn(rec):
        # the driver has just read the iteration's metrics, so the card
        # has finished its update (train_device: the whole iteration)
        ends.append(time.perf_counter())
        recv_s.append(0.0)
        if rec["iter"] == 1:
            prof.start()
        elif rec["iter"] == 2:
            torch.cuda.synchronize()
            prof.stop()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    setattr(ppo, maker, timed_maker)
    try:
        state, net, history = driver(pool, cfg, seed=SEED, log_fn=log_fn)
    finally:
        setattr(ppo, maker, make_update)
    torch.cuda.synchronize()
    launches = read_counts(f"{name} {task}", path)
    updates = iters * cfg.epochs * cfg.minibatches
    if len(history) != iters or int(state.step) != updates:
        raise AssertionError(f"{name} {task}: {len(history)} iterations, "
                             f"{int(state.step)} updates")
    metrics = ("loss", "pg", "vf", "ent", "ratio") + (
        () if beside is None else ("rho_behavior",))
    for rec in history:
        bad = [k for k in metrics if not np.isfinite(rec[k])]
        if bad:
            raise AssertionError(f"{name} {task} iter {rec['iter']}: "
                                 f"non-finite {bad}")
    for leaf in tree_leaves(state.params):
        if leaf.device.type != torch.device(DEV).type \
                or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name} {task}: params not finite on "
                                 f"{DEV}")
    t_prof = time.perf_counter()
    summary = device_summary(prof, 1, "iter")
    streams = None if beside is None else stream_overlap(prof, path)
    api = host_api(prof)
    dt = ends[1] - ends[0]
    busy = summary["device_busy_ms_per_iter"]
    out = {"driver": name, "task": task, "num_envs": n,
           "batch_size": pool.batch_size,
           "num_steps": num_steps, "epochs": cfg.epochs,
           "minibatches": cfg.minibatches, "iterations": iters,
           "net": "nature-cnn" if net.pixel else list(net.hidden),
           "env_steps_per_s": num_steps * n / dt,
           "frames_per_s": num_steps * frames_per_batch(pool) / dt,
           "ms_per_iter": dt * 1e3,
           "recv_host_ms_per_iter": recv_s[1] * 1e3,
           "update_host_ms_per_iter": update_s[1] * 1e3,
           "warmup_ms": (ends[0] - t0) * 1e3,
           "profiled_ms": (ends[2] - ends[1]) * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "history": [{k: r[k] for k in ("iter",) + metrics + (
               "episodes", "mean_return")} for r in history]}
    out.update(summary)
    out.update(api)
    out["top3_ms_per_iter"] = top3(summary, "iter")
    out["device_idle_share"] = (None if busy is None
                                else 1.0 - busy / out["ms_per_iter"])
    extra = ""
    if streams is not None:
        out.update(streams)
        out["device_idle_share"] = 1.0 - (streams["device_union_ms"]
                                          / out["ms_per_iter"])
        out["train_device_ms_per_iter"] = beside["ms_per_iter"]
        out["ms_per_iter_vs_train_device"] = (out["ms_per_iter"]
                                              / beside["ms_per_iter"])
        extra = (f" against train_device's {beside['ms_per_iter']:.1f} "
                 f"({out['ms_per_iter_vs_train_device']:.3f}x); overlap "
                 f"share {streams['overlap_share']}, kernels on the "
                 f"update stream {streams['update_stream_kernel_ms']:.1f} "
                 f"ms and the collect's "
                 f"{streams['collect_stream_kernel_ms']:.1f}, any kernel "
                 f"running {streams['device_union_ms']:.1f} ms of the "
                 f"profiled {out['profiled_ms']:.1f}; rho_behavior "
                 f"{[r['rho_behavior'] for r in history]}")
    out["profile_read_s"] = time.perf_counter() - t_prof
    log(f"  {name} {task} N={n} T={num_steps}: "
        f"{out['env_steps_per_s']:.0f} env steps/s, "
        f"{out['frames_per_s']:.0f} frames/s, {out['ms_per_iter']:.1f} "
        f"ms/iter ({out['recv_host_ms_per_iter']:.1f} in the recvs, "
        f"{out['update_host_ms_per_iter']:.1f} in the update's call)"
        f"{extra}, device busy {busy} ms/iter, idle share "
        f"{out['device_idle_share']}, top3 {out['top3_ms_per_iter']}, "
        f"peak {out['peak_mem_gb']:.2f} GB, launches {launches}; in the "
        f"profiled iteration {api['launch_api_calls']} kernel launches "
        f"took {api['launch_api_ms']:.1f} ms of host (longest "
        f"{api['launch_api_max_ms']:.3f}), synchronize calls "
        f"{api['sync_api_ms']:.1f} ms; {CARD}")
    del state, net, pool
    torch.cuda.empty_cache()
    return out


def serve_spec(vocab: int):
    """The token spec of a serving policy: no env, a 2-token obs."""
    import torch

    from repro_torch.core.specs import ArraySpec, EnvSpec

    return EnvSpec("serve-lm", ArraySpec((2,), torch.int32, 0, vocab - 1),
                   ArraySpec((), torch.int32, 0, vocab - 1))


def serve_requests(vocab: int, count: int, prompt_len: tuple[int, int],
                   long_new: int, short_new: int, seed: int):
    """Prompts of ragged length and ragged budgets (a quarter long),
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, rng.integers(prompt_len[0],
                                                   prompt_len[1] + 1)).tolist()
               for _ in range(count)]
    budgets = [long_new if rng.random() < 0.25 else short_new
               for _ in range(count)]
    return prompts, budgets


def qwen3_params():
    """qwen3-0.6b at full width on the card, weights from a seeded
    generator (f32 parameters, bf16 compute)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.rl.policy_lm import LMPolicy

    cfg = get_config(SERVE_MODEL)
    pol = LMPolicy(serve_spec(cfg.vocab), cfg, max_len=SERVE_MAX_LEN,
                   device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    return cfg, pol, pol.init(gen)


def drive_serve(cfg, pol, params) -> dict:
    """``DecodePool.serve`` on the qwen3-0.6b serving cell, then five
    decode steps of a full block under ``torch.profiler``."""
    import torch

    from repro_torch.serving import DecodePool

    pool = DecodePool(pol, SERVE_LANES, MAX_NEW_LONG, schedule="fifo")
    prompts, budgets = serve_requests(cfg.vocab, SERVE_REQUESTS, PROMPT_LEN,
                                      MAX_NEW_LONG, MAX_NEW_SHORT, SEED)
    pool.serve(params, prompts[:2], max_new=[2, 2])      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    outputs, stats = pool.serve(params, prompts, continuous=True,
                                max_new=budgets)
    launches = read_counts("serve", ("decode_attention",))
    if [len(o) for o in outputs] != budgets:
        raise AssertionError("serve: a request got the wrong token count")
    flat = np.array([t for o in outputs for t in o])
    if flat.min() < 0 or flat.max() >= cfg.vocab:
        raise AssertionError("serve: a token outside the vocabulary")
    calls = launches["decode_attention"] / cfg.n_layers
    if calls != int(calls) or calls < stats.decode_steps:
        raise AssertionError(f"serve: {launches['decode_attention']} "
                             "decode_attention launches do not match "
                             f"{stats.decode_steps} decode steps")
    out = {"model": cfg.name, "lanes": SERVE_LANES,
           "requests": SERVE_REQUESTS, "max_len": SERVE_MAX_LEN,
           "tokens": stats.total_tokens, "decode_steps": stats.decode_steps,
           "decode_step_calls": int(calls), "seconds": stats.wall_s,
           "tokens_per_s": stats.tokens_per_s,
           "lane_utilization": stats.utilization,
           "ms_per_decode_step_call": stats.wall_s * 1e3 / calls,
           "launches": launches}

    # a full block: every lane admitted, then profiled decode steps
    lanes = pool.init_lanes()
    cast = pol.cast_params(params)
    P = PROMPT_LEN[1]
    prompt = torch.from_numpy(np.array(
        [(p + [0] * P)[:P] for p in prompts[:SERVE_LANES]], np.int32)).to(DEV)
    lanes, _ = pool._admit_impl(
        cast, lanes, torch.ones(SERVE_LANES, dtype=torch.bool, device=DEV),
        prompt, torch.full((SERVE_LANES,), P, dtype=torch.int32,
                           device=DEV),
        torch.arange(SERVE_LANES, dtype=torch.int32, device=DEV),
        torch.full((SERVE_LANES,), MAX_NEW_LONG, dtype=torch.int32,
                   device=DEV))
    state = [lanes]

    def step():
        state[0] = pool._step_impl(cast, state[0])[0]

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    out["ms_per_decode_step_unprofiled"] = (time.perf_counter() - t0) / 5e-3
    out.update(profile_device(step, 5, unit="step"))
    busy = out["device_busy_ms_per_step"]
    out["device_idle_share"] = (
        None if busy is None else 1.0 - busy / out["ms_per_decode_step_call"])
    log(f"  serve {cfg.name} {SERVE_LANES} lanes, {SERVE_REQUESTS} "
        f"requests: {stats.tokens_per_s:.1f} tokens/s, utilization "
        f"{stats.utilization:.3f}, {stats.decode_steps} decode steps "
        f"({int(calls)} decode_step calls with prefill), "
        f"{out['ms_per_decode_step_call']:.2f} ms per call, device busy "
        f"{busy} ms per step, launches {launches}")
    return out


def drive_collect(cfg, params, recvs: int = 64) -> dict:
    """The sampled LM collect with the qwen3-0.6b policy on
    TokenRagged-v0 N=256/M=128 sjf, vocab 151936."""
    import torch

    import repro_torch
    from repro_torch.rl.policy_lm import LMPolicy, build_lm_collect_fn

    pool = repro_torch.make("TokenRagged-v0", num_envs=256, batch_size=128,
                            schedule="sjf", vocab=cfg.vocab, device=DEV)
    pol = LMPolicy(pool.spec, cfg, device=DEV)
    lanes = pol.init_lanes(pool.num_envs)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
    key = repro_torch.random.PRNGKey(SEED + 1, device=DEV)
    ps, lanes, ts, _, _ = build_lm_collect_fn(pool, pol, 2)(
        ps, lanes, params, ts, key)                     # warm-up
    torch.cuda.synchronize()
    collect = build_lm_collect_fn(pool, pol, recvs)
    reset_counts()
    t0 = time.perf_counter()
    ps, lanes, ts, traj, acts = collect(ps, lanes, params, ts, key)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("collect", ("decode_attention",))
    if launches["decode_attention"] != recvs * cfg.n_layers:
        raise AssertionError(f"collect: {launches['decode_attention']} "
                             f"decode_attention launches, want "
                             f"{recvs * cfg.n_layers}")
    if acts.shape != (recvs, 128) or int(acts.min()) < 0 \
            or int(acts.max()) >= cfg.vocab:
        raise AssertionError("collect: actions of the wrong shape or range")
    tokens = recvs * pool.batch_size
    out = {"task": "TokenRagged-v0", "num_envs": 256, "batch_size": 128,
           "model": cfg.name, "recvs": recvs, "seconds": dt,
           "tokens_per_s": tokens / dt, "ms_per_recv": dt / recvs * 1e3,
           "episodes_done": int(traj.done.sum()), "launches": launches}
    short = build_lm_collect_fn(pool, pol, 1)
    cast = pol.cast_params(params)      # as one collect call holds them
    state = [ps, lanes, ts]

    def recv():
        ps, lanes, ts = state
        state[:] = short(ps, lanes, cast, ts, key)[:3]

    out.update(profile_device(recv, 3))
    busy = out["device_busy_ms_per_recv"]
    out["device_idle_share"] = (None if busy is None
                                else 1.0 - busy / out["ms_per_recv"])
    log(f"  collect {cfg.name} TokenRagged-v0 N=256 M=128 sjf: "
        f"{out['tokens_per_s']:.1f} tokens/s, {out['ms_per_recv']:.2f} "
        f"ms/recv, device busy {busy} ms/recv, launches {launches}")
    return out


def model_params(arch: str, **overrides):
    """``build_model`` of ``arch`` at full width on the card, weights from
    a seeded generator there (f32 parameters, bf16 compute)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config(arch, **overrides), DEV)
    return model, model.init(torch.Generator(device=DEV).manual_seed(SEED))


def top3(prof: dict, unit: str) -> dict:
    top = prof[f"top_kernels_ms_per_{unit}"]
    return None if top is None else dict(list(top.items())[:3])


def analytic_bound(cfg, kind: str, seq: int, batch: int, ms: float) -> dict:
    """The row's cell in ``distributed/analytic.py``'s model,
    ``cell_cost(cfg, ShapeSpec(kind, seq, batch), 1)`` (``repro``'s at
    the config's ``remat``), and its bound on the card: the larger of its
    FLOPs over the dense bf16 peak and its bytes over the memory rate;
    ``of_bound`` = bound_ms / ``ms``, the row's own time."""
    from repro_torch.distributed.analytic import cell_cost
    from repro_torch.models import ShapeSpec

    cost = cell_cost(cfg, ShapeSpec(kind, kind, seq, batch), 1)
    flops_ms = cost.flops_global / BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = cost.bytes_per_device / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    return {"analytic_cell": f"{kind} S={seq} B={batch}",
            "analytic_flops": cost.flops_global,
            "analytic_bytes": cost.bytes_per_device,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "of_bound": bound_ms / ms}


def bound_text(row: dict) -> str:
    return (f"analytic {row['analytic_flops']:.4g} FLOP, "
            f"{row['analytic_bytes']:.4g} bytes, bound {row['bound_ms']:.3f}"
            f" ms ({row['bound_by']}), {row['of_bound']:.4f} of it")


def drive_prefill(model, params, batch: int, seq: int, calls: int = 3,
                  inputs: dict | None = None) -> dict:
    """``make_prefill_step(model, seq)`` on ``batch`` synthetic prompts of
    ``seq`` positions (``inputs``, if given: a vlm's patch embeddings,
    tokens and positions), the cache exactly as long as the prompt (the
    blocked branch: one flash_attention launch per layer and call; none
    in an xLSTM, whose cache is its per-layer states)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import make_prefill_step, synth_batch
    from repro_torch.models import ShapeSpec

    cfg = model.cfg
    copies = flash_attention.copies
    step = make_prefill_step(model, seq)
    if inputs is None:
        inputs = synth_batch(model, ShapeSpec("prefill", "prefill", seq,
                                              batch),
                             torch.Generator(device=DEV).manual_seed(SEED))
    logits, cache = model.prefill(params, inputs, max_len=seq)  # warm-up
    if logits.shape != (batch, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill {cfg.name}: logits "
                             f"{tuple(logits.shape)}, or not finite")
    want = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    if int(cache["len"]) != seq or ("k" in cache and tuple(
            cache["k"].shape) != want):
        raise AssertionError(f"prefill {cfg.name}: cache len "
                             f"{int(cache['len'])}, want {seq}, k {want}")
    states = cache.get("states", [])
    if cfg.ssm is not None:
        states = [(cache["ssm_h"], cache["ssm_tail"])]
    for st in states:
        if not (all(bool(torch.isfinite(t).all()) for t in st)
                and bool(st[0].any())):
            raise AssertionError(f"prefill {cfg.name}: a recurrent state "
                                 "is zero or not finite")
    del logits, cache
    flash = cfg.attn_impl == "blocked" and cfg.family != "ssm"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        nxt, cache = step(params, inputs)
        del cache
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(f"prefill {cfg.name}",
                           ("flash_attention",) if flash else ())
    if launches["flash_attention"] != calls * cfg.n_layers * flash:
        raise AssertionError(f"prefill {cfg.name}: "
                             f"{launches['flash_attention']} flash_attention "
                             f"launches, want {calls * cfg.n_layers * flash}")
    if nxt.shape != (batch,) or int(nxt.min()) < 0 \
            or int(nxt.max()) >= cfg.vocab:
        raise AssertionError(f"prefill {cfg.name}: next tokens out of range")
    if flash_attention.copies != copies:
        raise AssertionError(f"prefill {cfg.name}: flash_attention copied "
                             f"{flash_attention.copies - copies} inputs")
    out = {"model": cfg.name, "layers": cfg.n_layers,
           "attn_type": cfg.attn_type,
           "window": cfg.window if cfg.attn_type == "sliding" else 0,
           "batch": batch, "seq_len": seq, "calls": calls, "seconds": dt,
           "tokens_per_s": calls * batch * seq / dt,
           "ms_per_call": dt / calls * 1e3,
           "flash_launches_per_call": launches["flash_attention"] / calls,
           "flash_copies": flash_attention.copies - copies,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    prof = profile_device(lambda: step(params, inputs), 1, unit="call")
    busy = prof["device_busy_ms_per_call"]
    out.update(device_busy_ms_per_call=busy,
               kernels_per_call=prof["kernels_per_call"],
               top3_kernels_ms_per_call=top3(prof, "call"),
               device_idle_share=(None if busy is None
                                  else 1.0 - busy / out["ms_per_call"]))
    out.update(analytic_bound(cfg, "prefill", seq, batch,
                              out["ms_per_call"]))
    log(f"  prefill {cfg.name} {cfg.attn_type} B={batch} S={seq}: "
        f"{out['tokens_per_s']:.0f} tokens/s, {out['ms_per_call']:.1f} ms "
        f"per call, device busy {busy} ms per call, flash launches per call "
        f"{out['flash_launches_per_call']}, peak {out['peak_gb']:.2f} GB, "
        f"top {out['top3_kernels_ms_per_call']}; {bound_text(out)}")
    return out


def branch_ms(model, params, row: dict) -> dict:
    """The MoE FFN (``apply_moe``) and the SSM branch (``apply_ssm``) of
    layer 0 alone, at ``row``'s prefill shape, on a (B, S, d) input in
    the compute dtype from a seeded generator (CUDA events, no grad):
    ms a layer and, over ``n_layers``, the share of the prefill's ms a
    call.  Neither has a kernel of its own: ``repro`` computes both in
    jnp, and these times rank them as candidates for one."""
    import torch

    from repro_torch.models.moe import apply_moe
    from repro_torch.models.ssm import apply_ssm
    from repro_torch.models.transformer import unstack_layers

    cfg = model.cfg
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    x = torch.randn((row["batch"], row["seq_len"], cfg.d_model),
                    generator=gen, device=DEV).to(cfg.compute_dtype)
    layer = unstack_layers(params["layers"], cfg.n_layers)[0]
    parts = {}
    with torch.no_grad():
        if cfg.moe is not None:
            parts["moe"] = lambda: apply_moe(layer["moe"], x, cfg)
        if cfg.ssm is not None:
            parts["ssm"] = lambda: apply_ssm(layer["ssm"], x, cfg)
        out = {}
        for name, fn in parts.items():
            ms = time_ms(fn, reps=3, trials=3)
            out[f"{name}_ms_per_layer"] = ms
            out[f"{name}_share_of_call"] = ms * cfg.n_layers / row[
                "ms_per_call"]
            log(f"  {cfg.name} {name} alone: {ms:.3f} ms a layer, "
                f"{out[f'{name}_share_of_call']:.3f} of a prefill call")
    return out


def drive_model_serve(model, params, batch: int, prompt: int,
                      max_len: int, steps: int, inputs: dict | None = None,
                      positions=None) -> dict:
    """``make_prefill_step`` of ``batch`` prompts of ``prompt`` positions
    into a ``max_len`` cache (the dense cached branch: S < L; an encdec
    model encodes its frames first; ``inputs``, if given, is the prompt),
    then ``steps`` greedy ``make_serve_step`` tokens (``positions(t)``,
    if given, the (B, 1, 3) M-RoPE positions of step t)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_serve_step,
        synth_batch,
    )
    from repro_torch.models import ShapeSpec

    cfg = model.cfg
    prefill = make_prefill_step(model, max_len)
    serve = make_serve_step(model)
    if inputs is None:
        inputs = synth_batch(model, ShapeSpec("serve", "prefill", prompt,
                                              batch),
                             torch.Generator(device=DEV).manual_seed(SEED + 1))

    def step_batch(t, nxt):
        b = {"tokens": nxt[:, None]}
        if positions is not None:
            b["positions"] = positions(t)
        return b

    def run(n):
        """Prefill, then ``n`` greedy steps; the tokens, the cache and
        the host times at the start, after the prefill and at the end."""
        t = [time.perf_counter()]
        nxt, cache = prefill(params, inputs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        toks = [nxt]
        for i in range(n):
            nxt, cache = serve(params, cache, step_batch(i, nxt))
            toks.append(nxt)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return torch.stack(toks, 1), cache, t

    run(2)                                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    copies = flash_attention.copies
    toks, cache, (t0, t1, t2) = run(steps)
    launches = read_counts(f"serve {cfg.name}", ())
    if toks.shape != (batch, steps + 1) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"serve {cfg.name}: tokens out of range")
    if int(cache["len"]) != prompt + steps:
        raise AssertionError(f"serve {cfg.name}: cache len "
                             f"{int(cache['len'])}, want {prompt + steps}")
    out = {"model": cfg.name, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "max_len": max_len, "steps": steps,
           "prefill_ms": (t1 - t0) * 1e3,
           "ms_per_step": (t2 - t1) / steps * 1e3,
           "tokens_per_s": batch * steps / (t2 - t1),
           "flash_copies": flash_attention.copies - copies,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    state = [cache, toks[:, -1]]

    def one():
        state[1], state[0] = serve(params, state[0],
                                   step_batch(steps, state[1]))

    prof = profile_device(one, 1, unit="step")
    busy = prof["device_busy_ms_per_step"]
    out.update(device_busy_ms_per_step=busy,
               kernels_per_step=prof["kernels_per_step"],
               top3_kernels_ms_per_step=top3(prof, "step"),
               device_idle_share=(None if busy is None
                                  else 1.0 - busy / out["ms_per_step"]))
    # a step reads the whole static cache of max_len positions
    out.update(analytic_bound(cfg, "decode", max_len, batch,
                              out["ms_per_step"]))
    log(f"  serve {cfg.name} B={batch} prompt {prompt} cache {max_len}: "
        f"prefill {out['prefill_ms']:.1f} ms, {out['tokens_per_s']:.1f} "
        f"tokens/s, {out['ms_per_step']:.2f} ms per step, device busy "
        f"{busy} ms per step, {out['kernels_per_step']} kernels a step, "
        f"peak {out['peak_gb']:.2f} GB, top "
        f"{out['top3_kernels_ms_per_step']}; {bound_text(out)}")
    return out


def vlm_inputs(cfg, batch: int, grid: int, text: int, seed: int) -> dict:
    """A qwen2-vl prompt on the card: ``grid`` x ``grid`` patch embeddings
    (normals x 0.02 from a seeded generator, in the compute dtype), then
    ``text`` seeded tokens; Qwen2-VL's positions: the patches at (0,
    row, col), the text from the grid's largest id + 1 with t = h = w.
    Returns the prefill batch and ``positions(t)``, the (B, 1, 3) ids
    of decode step t."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    idx = torch.arange(grid * grid, device=DEV)
    patches = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid],
                          -1)
    t = grid + torch.arange(text, device=DEV)
    pos = torch.cat([patches, torch.stack([t, t, t], -1)])
    batch_in = {
        "patch_embeds": (torch.randn((batch, grid * grid, cfg.d_model),
                                     generator=gen, device=DEV) * 0.02
                         ).to(cfg.compute_dtype),
        "tokens": torch.randint(0, cfg.vocab, (batch, text), generator=gen,
                                device=DEV, dtype=torch.int32),
        "positions": pos.to(torch.int32).expand(batch, -1, -1)}

    def positions(step: int):
        return torch.full((batch, 1, 3), grid + text + step,
                          dtype=torch.int32, device=DEV)

    return batch_in, positions


def family_phase() -> list[dict]:
    """Phase 3's xLSTM, Whisper and vlm rows at full width, each also
    served: qwen2-vl-72b at ``VLM_LAYERS`` of its 80 layers (blocked
    prefill of 2 x (1024 patches + 3072 tokens) into a cache of 4096,
    ``VLM_LAYERS`` flash launches a call; then a 4096 + 32 cache and 32
    decode steps); whisper-large-v3 whole (8 clips of 1500 frames, the
    encoder alone timed, a 16-token prompt into a cache of 64, 48
    steps); xlstm-125m whole (prefill B=8 S=2048, 8 chunks of 256; 32
    steps; then B=1, the ``long_500k`` cell's decode step)."""
    import torch

    from repro_torch.launch.steps import synth_batch
    from repro_torch.models import ShapeSpec
    from repro_torch.models.whisper import encode

    rows = []
    model, params = model_params("qwen2-vl-72b", n_layers=VLM_LAYERS,
                                 attn_impl="blocked")
    seq = VLM_GRID * VLM_GRID + VLM_TEXT
    inputs, positions = vlm_inputs(model.cfg, 2, VLM_GRID, VLM_TEXT,
                                   SEED + 2)
    rows.append(drive_prefill(model, params, 2, seq, inputs=inputs))
    rows.append(drive_model_serve(model, params, 2, seq, seq + 32, 32,
                                  inputs=inputs, positions=positions))
    del model, params, inputs
    torch.cuda.empty_cache()

    model, params = model_params("whisper-large-v3")
    inputs = synth_batch(model, ShapeSpec("serve", "prefill", 16, 8),
                         torch.Generator(device=DEV).manual_seed(SEED + 3))
    row = drive_model_serve(model, params, 8, 16, 64, 48, inputs=inputs)
    with torch.no_grad():
        ms = time_ms(lambda: encode(params, inputs["frames"], model.cfg),
                     reps=1, trials=3)
    row.update(encode_ms=ms, encode_share_of_prefill=ms / row["prefill_ms"])
    log(f"  {model.cfg.name} encoder alone ({len(inputs['frames'])} x "
        f"{model.cfg.enc_seq} frames): {ms:.2f} ms, "
        f"{row['encode_share_of_prefill']:.3f} of the prompt's prefill")
    rows.append(row)
    del model, params, inputs, row
    torch.cuda.empty_cache()

    model, params = model_params("xlstm-125m")
    rows.append(drive_prefill(model, params, 8, 2048, calls=2))
    rows.append(drive_model_serve(model, params, 8, 2048, 2048, 32))
    row = drive_model_serve(model, params, 1, 256, 256, 32)
    row["cell"] = "long_500k decode step (B=1; O(1) in the context)"
    rows.append(row)
    del model, params
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------- #
# phase 5: the host engines
# ---------------------------------------------------------------------- #
# the kernels each launch per host env step / per recv, by task
HOST_PER_STEP = {"Ant-v3": ("env_step",), "PongClassic-v5": ("pong_render",)}
HOST_PER_RECV = {"Ant-v3": (), "PongClassic-v5": ("grayscale", "resize")}


def host_steps(pool, tables, recvs: int, out):
    """``recvs`` steps of a host pool, actions routed by ``env_id``;
    returns the last block and the number of results served by a step."""
    stepped = 0
    for t in range(recvs):
        ids = out["env_id"].long().cpu()
        out = pool.step(tables[t % len(tables)][ids], out["env_id"])
        stepped += out["env_id"].numel()
    return out, stepped


def drive_host(task: str, n: int, m: int | None, engine: str, dev: str,
               recvs: int, num_threads: int | None = None) -> dict:
    """One host-engine row: env steps/s and ms per recv over ``recvs``
    recvs after a warm-up of two, the kernels of the path launched per
    env step (env_step, pong_render) and per recv (grayscale, resize),
    the CUDA kernels and device busy a recv (``torch.profiler``, three
    more recvs; not for a subprocess row), ``stats()`` with its
    conservation laws.  A sync row must launch each
    per-step kernel exactly once per env step and each per-recv kernel
    once per recv; a subprocess row's env steps launch in its workers,
    whose counts ``pool.launches()`` reads.  An async row's window also
    counts steps begun before it and still in flight after it, so its
    counts stay out of the ``kernels`` line (``launches`` is empty,
    ``launches_in_window`` has them)."""
    import torch

    import repro_torch

    pool = repro_torch.make(task, num_envs=n, batch_size=m, engine=engine,
                            num_threads=num_threads, device=dev)
    tag = f"host {task} {engine} N={n} M={pool.batch_size} {dev}"
    try:
        tables = [t.cpu() for t in action_tables(
            pool, 8, np.random.default_rng(SEED))]
        if pool.batch_size < n:
            pool.async_reset()
            out = pool.recv()
        else:
            out = pool.reset()
        out, _ = host_steps(pool, tables, 2, out)
        if dev == DEV:
            torch.cuda.synchronize()
        sub = engine == "subprocess"
        # a subprocess worker's launches count in its own process
        base = pool.launches() if sub else {}
        reset_counts()
        t0 = time.perf_counter()
        out, stepped = host_steps(pool, tables, recvs, out)
        if dev == DEV:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        on_card = dev == DEV
        workers = pool.launches() if sub else {}
        launches = {k: v + workers.get(k, 0) - base.get(k, 0)
                    for k, v in read_counts(tag, ()).items()}
        step_kernels = HOST_PER_STEP[task]
        path = step_kernels + HOST_PER_RECV[task] if on_card else ()
        for k in path:
            if launches[k] == 0:
                raise AssertionError(f"{tag}: kernel {k} never launched")
        per_step = {k: launches[k] / stepped for k in step_kernels}
        per_recv = {k: launches[k] / recvs for k in HOST_PER_RECV[task]}
        sync = pool.batch_size == n
        if on_card and sync and (
                any(v != 1 for v in per_step.values())
                or any(v != 1 for v in per_recv.values())):
            raise AssertionError(f"{tag}: launches {launches} over {recvs} "
                                 f"recvs of {stepped} env steps")
        want = (pool.batch_size,) + tuple(pool.spec.obs_spec.shape)
        if tuple(out["obs"].shape) != want or out["obs"].device.type != \
                torch.device(dev).type:
            raise AssertionError(f"{tag}: obs {tuple(out['obs'].shape)} on "
                                 f"{out['obs'].device}, want {want}")
        stats = pool.stats()
        check_stats(tag, stats, pool.batch_size)
        row = {"task": task, "engine": engine, "device": dev, "num_envs": n,
               "batch_size": pool.batch_size,
               "num_threads": getattr(pool, "num_threads",
                                      getattr(pool, "num_workers", 1)),
               "recvs": recvs, "seconds": dt,
               "env_steps_per_s": stepped / dt,
               "ms_per_recv": dt / recvs * 1e3,
               "launches": launches if sync else {},
               "launches_in_window": launches,
               "launches_per_env_step": per_step,
               "launches_per_recv": per_recv,
               "stats": {k: stats[k] for k in (
                   "recvs", "served", "stepped", "occupancy", "cost_sum",
                   "wait_ticks_total")}}
        row["stats"]["wait_hist"] = stats["wait_hist"].tolist()
        # a subprocess row's kernels run in its workers, which this
        # process's profiler does not see
        if on_card and engine != "subprocess":
            state = [out]

            def recv():
                state[0], _ = host_steps(pool, tables, 1, state[0])

            row.update(profile_device(recv, 3))
            busy = row["device_busy_ms_per_recv"]
            row["device_idle_share"] = (None if busy is None
                                        else 1.0 - busy / row["ms_per_recv"])
    finally:
        pool.close()
    log(f"  {tag}: {row['env_steps_per_s']:.1f} env steps/s, "
        f"{row['ms_per_recv']:.1f} ms/recv, launches per env step "
        f"{per_step}, per recv {per_recv}, kernels/recv "
        f"{row.get('kernels_per_recv')}, device busy "
        f"{row.get('device_busy_ms_per_recv')} ms/recv; stats "
        f"{row['stats']}")
    log(json.dumps({"host_row": row, "card": CARD}))
    return row


def drive_train_host(n: int = 16, num_steps: int = 16) -> dict:
    """``train_host`` on Ant-v3, the thread engine, N=n sync with the
    envs on the CPU and the learner on the card (MLP 256-128-64,
    ``PPOConfig``'s 4 epochs of 4 minibatches), two iterations: the first
    warms up, the second is timed, its four Fig. 4 buckets (env_step,
    inference, train, other) read off the tracer's totals."""
    import torch

    import repro_torch
    from repro_torch.obs.trace import Tracer
    from repro_torch.rl.ppo import PPOConfig, train_host
    from repro_torch.utils.tree import tree_leaves

    pool = repro_torch.make("Ant-v3", num_envs=n, engine="thread",
                            device="cpu")
    cfg = PPOConfig(total_steps=2 * num_steps * n, num_steps=num_steps)
    tr = Tracer()
    marks = []

    def log_fn(rec):
        marks.append((time.perf_counter(), tr.totals()))

    try:
        reset_counts()
        state, _, history, prof = train_host(pool, cfg=cfg, seed=SEED,
                                             tracer=tr, log_fn=log_fn,
                                             device=DEV)
        torch.cuda.synchronize()
    finally:
        pool.close()
    launches = read_counts("train_host", ())
    (t1, tot1), (t2, tot2) = marks
    buckets = {k: (tot2.get(k, 0.0) - tot1.get(k, 0.0)) * 1e3
               for k in ("env_step", "inference", "train", "other")}
    for leaf in tree_leaves(state.params):
        if leaf.device.type != torch.device(DEV).type \
                or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"train_host: params not finite on {DEV}")
    if len(history) != 2 or not all(np.isfinite(r["loss"]) for r in history):
        raise AssertionError(f"train_host: history {history}")
    ms = (t2 - t1) * 1e3
    row = {"task": "Ant-v3", "engine": "thread", "env_device": "cpu",
           "learner_device": DEV, "num_envs": n, "num_steps": num_steps,
           "epochs": cfg.epochs, "minibatches": cfg.minibatches,
           "ms_per_iter": ms, "env_steps_per_s": num_steps * n / ms * 1e3,
           "buckets_ms": buckets,
           "bucket_share": {k: v / ms for k, v in buckets.items()},
           "launches": launches,
           "history": [{k: r[k] for k in ("iter", "loss", "episodes")}
                       for r in history]}
    log(f"  train_host Ant-v3 N={n} T={num_steps} (envs on the CPU, learner "
        f"on the card): {ms:.0f} ms/iter, {row['env_steps_per_s']:.1f} env "
        f"steps/s, buckets ms {buckets}")
    log(json.dumps({"train_host": row, "card": CARD}))
    return row


def drive_train_host_pipelined(beside: dict, n: int = 16,
                               num_steps: int = 16, env_device: str = "cpu"
                               ) -> dict:
    """``train_host_pipelined`` on Ant-v3, the thread engine, N=n sync
    with the envs on ``env_device`` and the learner on the card (MLP
    256-128-64, ``PPOConfig``'s 4 epochs of 4 minibatches), three
    iterations: the first warms up, the second and third are timed, their
    buckets (actor_wait, train, other) read off the tracer's totals and
    set beside ``beside``'s, the ``train_host`` row of the same layout.
    The actor runs ahead of the learner by up to the ring's two blocks,
    so the launches count more env steps than the learner consumed.
    With the envs on the card env_step must have launched."""
    import torch

    import repro_torch
    from repro_torch.obs.trace import Tracer
    from repro_torch.rl.ppo import PPOConfig, train_host_pipelined
    from repro_torch.utils.tree import tree_leaves

    pool = repro_torch.make("Ant-v3", num_envs=n, engine="thread",
                            device=env_device)
    iters = 3
    cfg = PPOConfig(total_steps=iters * num_steps * n, num_steps=num_steps)
    tr = Tracer()
    marks = []

    def log_fn(rec):
        marks.append((time.perf_counter(), tr.totals()))

    try:
        reset_counts()
        state, _, history, prof = train_host_pipelined(
            pool, cfg=cfg, seed=SEED, tracer=tr, log_fn=log_fn, device=DEV)
        torch.cuda.synchronize()
    finally:
        pool.close()
    tag = f"train_host_pipelined envs on {env_device}"
    launches = read_counts(tag, ("env_step",) if env_device == DEV else ())
    (t1, tot1), (t3, tot3) = marks[0], marks[-1]
    timed = iters - 1
    buckets = {k: (tot3.get(k, 0.0) - tot1.get(k, 0.0)) * 1e3 / timed
               for k in ("actor_wait", "train", "other")}
    for leaf in tree_leaves(state.params):
        if leaf.device.type != torch.device(DEV).type \
                or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{tag}: params not finite on {DEV}")
    if len(history) != iters or not all(
            np.isfinite(r[k]) for r in history
            for k in ("loss", "rho_behavior")):
        raise AssertionError(f"{tag}: history {history}")
    ms = (t3 - t1) * 1e3 / timed
    row = {"task": "Ant-v3", "engine": "thread", "env_device": env_device,
           "learner_device": DEV, "num_envs": n, "num_steps": num_steps,
           "epochs": cfg.epochs, "minibatches": cfg.minibatches,
           "iterations": iters, "ms_per_iter": ms,
           "env_steps_per_s": num_steps * n / ms * 1e3,
           "buckets_ms": buckets,
           "bucket_share": {k: v / ms for k, v in buckets.items()},
           "train_host_ms_per_iter": beside["ms_per_iter"],
           "train_host_buckets_ms": beside["buckets_ms"],
           "launches": launches,
           "history": [{k: r[k] for k in ("iter", "loss", "rho_behavior",
                                          "episodes")} for r in history]}
    log(f"  {tag}, learner on the card, Ant-v3 N={n} T={num_steps}: "
        f"{ms:.0f} ms/iter, {row['env_steps_per_s']:.1f} env steps/s, "
        f"buckets ms {buckets}; train_host {beside['ms_per_iter']:.0f} "
        f"ms/iter, buckets ms {beside['buckets_ms']}; rho_behavior "
        f"{[r['rho_behavior'] for r in history]}; launches {launches}")
    log(json.dumps({"train_host_pipelined": row, "card": CARD}))
    return row


def host_blocks(pool, steps: int, tables, out) -> tuple[list, dict]:
    """``out``, a host pool's reset block, and ``steps`` more blocks;
    every block's fields on the CPU, rows in ``env_id`` order, and
    ``stats()``."""
    blocks = []
    for t in range(steps + 1):
        order = out["env_id"].long().cpu().argsort()
        blocks.append({k: v.cpu()[order] for k, v in out.items()})
        if t < steps:
            out = pool.step(tables[t][out["env_id"].long().cpu()],
                            out["env_id"])
    return blocks, pool.stats()


def cross_check_host(task: str, atol: float | None, transforms=None,
                     n: int = 8, steps: int = 10) -> dict:
    """The thread and forloop engines on the card against the device
    engine on the card, from one seed with the same actions routed by
    ``env_id``: ids, reward, done and ``stats()`` bitwise, obs bitwise
    (``atol`` None) or within ``atol``; each of the path's kernels
    launched exactly once per env step (env_step, pong_render) or once
    per recv (grayscale, resize, crop) over the steps."""
    import torch

    import repro_torch

    kw = dict(num_envs=n, max_episode_steps=5, transforms=transforms)
    dpool = repro_torch.make(task, device=DEV, **kw)
    tables = [t.cpu() for t in action_tables(
        dpool, steps, np.random.default_rng(SEED + 2))]
    ps, ts = dpool.reset(repro_torch.random.PRNGKey(SEED))
    want = []
    for t in range(steps + 1):
        order = ts.env_id.long().cpu().argsort()
        want.append({k: getattr(ts, k).cpu()[order] for k in (
            "env_id", "reward", "done", "obs")})
        if t < steps:
            ps, ts = dpool.step(ps, tables[t][ts.env_id.long().cpu()].to(DEV),
                                ts.env_id)
    want_stats = dpool.stats(ps)
    per_recv = HOST_PER_RECV[task] + (("crop",) if transforms else ())
    errs = {}
    for engine in ("thread", "forloop"):
        tag = f"host {task} {engine} vs device"
        pool = repro_torch.make(task, engine=engine, device=DEV, seed=SEED,
                                **kw)
        try:
            out = pool.reset()
            torch.cuda.synchronize()
            reset_counts()
            got, stats = host_blocks(pool, steps, tables, out)
            torch.cuda.synchronize()
            launches = read_counts(tag, HOST_PER_STEP[task] + per_recv)
        finally:
            pool.close()
        expect = {k: steps * n for k in HOST_PER_STEP[task]}
        expect.update({k: steps for k in per_recv})
        if any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f"{tag}: launches {launches}, want {expect}")
        for k, v in want_stats.items():
            if not np.array_equal(stats[k], v):
                raise AssertionError(f"{tag}: stats()[{k!r}] differs")
        err = 0.0
        for t, (g, w) in enumerate(zip(got, want)):
            if g["obs"].device.type != "cpu":
                raise AssertionError(tag)
            for k in ("env_id", "reward", "done"):
                if not torch.equal(g[k], w[k]):
                    raise AssertionError(f"{tag} block {t}: {k} differs")
            e = float((g["obs"].float() - w["obs"].float()).abs().max())
            err = max(err, e)
            if (atol is None and e != 0.0) or (atol is not None
                                               and e > atol):
                raise AssertionError(f"{tag} block {t}: obs differ by {e}")
        errs[engine] = err
    log(f"  host {task} {[t.name for t in dpool.pipeline.transforms]} N={n}: "
        f"thread and forloop on the card == the device engine on the card "
        f"over {steps} steps (ids, reward, done, stats() bitwise; obs max abs "
        f"err {errs}); launches {expect}")
    return errs


def cross_check_host_cpu(task: str, atol: float | None, n: int = 8,
                         steps: int = 10) -> None:
    """The thread engine on the card against the thread engine on the
    CPU: ids, done, step_cost and ``stats()`` bitwise, reward and obs
    bitwise (``atol`` None) or within ``atol``."""
    import torch

    import repro_torch

    runs = {}
    for dev in (DEV, "cpu"):
        pool = repro_torch.make(task, num_envs=n, engine="thread",
                                device=dev, max_episode_steps=5)
        try:
            tables = [t.cpu() for t in action_tables(
                pool, steps, np.random.default_rng(SEED + 3))]
            runs[dev] = host_blocks(pool, steps, tables, pool.reset())
        finally:
            pool.close()
    (got, gstats), (want, cstats) = runs[DEV], runs["cpu"]
    tag = f"host {task} thread"
    for k, v in cstats.items():
        if not np.array_equal(gstats[k], v):
            raise AssertionError(f"{tag}: stats()[{k!r}] differs")
    for t, (g, c) in enumerate(zip(got, want)):
        for k in ("env_id", "done", "step_cost"):
            if not torch.equal(g[k], c[k]):
                raise AssertionError(f"{tag} block {t}: {k} differs")
        for k in ("reward", "obs"):
            ok = (torch.equal(g[k], c[k]) if atol is None else
                  torch.allclose(g[k], c[k], rtol=0, atol=atol))
            if not ok:
                raise AssertionError(f"{tag} block {t}: {k} differs")
    log(f"  {tag} N={n}: cuda == cpu over {steps} steps, stats() bitwise"
        + (" (bitwise)" if atol is None else f" (obs, reward within {atol})"))


def host_phase() -> list[dict]:
    """Phase 5: the checks, then the rows."""
    import repro_torch

    cropped = [repro_torch.Grayscale(), repro_torch.Crop(*PONG_CROP),
               repro_torch.Resize(84, 84), repro_torch.FrameStack(4),
               repro_torch.RewardClip()]
    cross_check_host("Ant-v3", 1e-4)
    cross_check_host("PongClassic-v5", None)
    cross_check_host("PongClassic-v5", None, transforms=cropped)
    cross_check_host_cpu("Ant-v3", 1e-4)
    cross_check_host_cpu("PongClassic-v5", None)
    rows = []
    for dev in (DEV, "cpu"):
        rows += [drive_host("Ant-v3", 32, None, "thread", dev, 5),
                 drive_host("Ant-v3", 32, 16, "thread", dev, 5),
                 drive_host("Ant-v3", 32, None, "forloop", dev, 5),
                 drive_host("Ant-v3", 32, None, "subprocess", dev, 5,
                            num_threads=4)]
    rows += [drive_host("PongClassic-v5", 16, None, "thread", DEV, 3),
             drive_host("PongClassic-v5", 16, 8, "thread", DEV, 3)]
    host_row = drive_train_host()
    rows += [host_row, drive_train_host_pipelined(host_row),
             drive_train_host_pipelined(host_row, n=8, num_steps=8,
                                        env_device=DEV)]
    return rows


# ---------------------------------------------------------------------- #
# phase 4: the card against the CPU
# ---------------------------------------------------------------------- #
def cross_check(task: str, atol: float | None, batch_size: int | None = 8,
                engine: str = "device", schedule: str = "fifo") -> None:
    """20 recvs of ``task`` N=16 on the card and on the CPU from one key:
    ids, done and costs equal, obs and reward bitwise (``atol`` None) or
    within ``atol``, and ``stats()`` bitwise."""
    import torch

    import repro_torch

    runs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        pool = repro_torch.make(task, num_envs=16, batch_size=batch_size,
                                engine=engine, schedule=schedule,
                                device=dev, max_episode_steps=7)
        tables = [t.cpu() for t in action_tables(
            pool, 20, np.random.default_rng(SEED + 1))]
        ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
        rec = []
        for t in range(20):
            a = tables[t][ts.env_id.long().cpu()].to(dev)
            ps, ts = pool.step(ps, a, ts.env_id)
            rec.append({k: getattr(ts, k).cpu() for k in
                        ("env_id", "done", "step_cost", "reward", "obs")})
        runs[dev] = rec
        stats[dev] = pool.stats(ps)
    tag = f"{task} {engine} M={batch_size} {schedule}"
    check_stats(tag, stats["cuda"], runs["cpu"][0]["env_id"].numel())
    for k, v in stats["cpu"].items():
        if not np.array_equal(stats["cuda"][k], v):
            raise AssertionError(f"{tag}: stats()[{k!r}] differs")
    for t, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for k in ("env_id", "done", "step_cost"):
            if not torch.equal(g[k], c[k]):
                raise AssertionError(f"{tag} recv {t}: {k} differs")
        for k in ("reward", "obs"):
            if atol is None:
                ok = torch.equal(g[k], c[k])
            else:
                ok = torch.allclose(g[k], c[k], rtol=0, atol=atol)
            if not ok:
                err = float((g[k].float() - c[k].float()).abs().max())
                raise AssertionError(f"{tag} recv {t}: {k} differs, max "
                                     f"abs err {err}")
    log(f"  {tag}: cuda == cpu over 20 recvs, stats() bitwise"
        + (" (bitwise)" if atol is None else f" (obs, reward within {atol})"))


def lm_policy_params(spec):
    """The f32 ``lm-policy`` backbone over ``spec``, weights drawn on the
    CPU from a seeded generator, and a copy on the card."""
    import torch

    from repro_torch.rl.policy_lm import LMPolicy, default_policy_config

    vocab = int(spec.act_spec.maximum) + 1
    cpu = LMPolicy(spec, default_policy_config(vocab), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(SEED))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    return {"cpu": params, "cuda": to(params, "cuda")}


def cross_check_serve() -> None:
    """``DecodePool.serve`` on the f32 lm-policy config: identical token
    lists on the card and the CPU (4 lanes, 8 requests)."""
    from repro_torch.rl.policy_lm import LMPolicy, default_policy_config
    from repro_torch.serving import DecodePool

    spec = serve_spec(256)
    params = lm_policy_params(spec)
    prompts, budgets = serve_requests(256, 8, (4, 16), 32, 8, SEED + 2)
    out = {}
    for dev in ("cuda", "cpu"):
        pol = LMPolicy(spec, default_policy_config(256, 49), max_len=49,
                       device=dev)
        out[dev] = DecodePool(pol, 4, 32).serve(params[dev], prompts,
                                                max_new=budgets)[0]
    if out["cuda"] != out["cpu"]:
        raise AssertionError("serve: token lists differ between cuda and cpu")
    log(f"  serve lm-policy: cuda == cpu, {sum(map(len, out['cpu']))} "
        "tokens identical")


def cross_check_collect(recvs: int = 16) -> None:
    """16 recvs of the sampled LM collect on TokenRagged-v0 N=16/M=8:
    identical actions, ids and dones on the card and the CPU."""
    import torch

    import repro_torch
    from repro_torch.rl.policy_lm import LMPolicy, build_lm_collect_fn

    runs = {}
    params = None
    for dev in ("cuda", "cpu"):
        pool = repro_torch.make("TokenRagged-v0", num_envs=16, batch_size=8,
                                schedule="sjf", device=dev)
        params = params or lm_policy_params(pool.spec)
        pol = LMPolicy(pool.spec, device=dev)
        ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
        _, _, _, traj, acts = build_lm_collect_fn(pool, pol, recvs)(
            ps, pol.init_lanes(16), params[dev], ts,
            repro_torch.random.PRNGKey(SEED + 3, device=dev))
        runs[dev] = (acts.cpu(), traj.env_id.cpu(), traj.done.cpu())
    for name, g, c in zip(("actions", "env_id", "done"), runs["cuda"],
                          runs["cpu"]):
        if not torch.equal(g, c):
            raise AssertionError(f"collect: {name} differ between cuda and "
                                 "cpu")
    log(f"  collect lm-policy TokenRagged-v0: cuda == cpu over {recvs} "
        "recvs (actions, ids, dones)")


def cross_check_train(task: str, n: int, atol: float | None,
                      pipelined: bool = False) -> None:
    """``train_device`` (``train_pipelined`` if ``pipelined``, its
    ``rho_behavior`` held as the losses are) at the CPU tests' size (N=n
    sync, 8 steps, hidden (32, 32), 5-step episodes) for 2 iterations of
    1 epoch of 2 minibatches on the card and on the CPU: the actions
    each step sent, equal (``atol`` None) or within ``atol``, the same
    episodes, losses within 1e-4 relative (``pg`` 1e-5 absolute), the
    final params within 1e-5.  TF32 is off, so the card's convs and
    matmuls are f32 too.

    Four updates, not ``PPOConfig``'s 32: over 32 a ReLU whose input
    sits at zero can open under one summation order and not another,
    and from then on Adam moves the weights apart by up to the learning
    rate a step (scripts/train_sensitivity.py: the CPU's oneDNN and
    plain convs end 4.65e-4 apart at seed 0, Pong N=4); over four they
    agree to 1.2e-7 at N = 4 and 8, seeds 0 to 5."""
    import torch

    import repro_torch
    from repro_torch.rl.ppo import PPOConfig, train_device, train_pipelined
    from repro_torch.utils.tree import tree_leaves_with_path

    driver = train_pipelined if pipelined else train_device
    name = driver.__name__
    runs = {}
    for dev in (DEV, "cpu"):
        pool = repro_torch.make(task, num_envs=n, device=dev,
                                max_episode_steps=5)
        acts = []
        step = pool.step

        def recording_step(ps, actions, env_ids, step=step, acts=acts):
            acts.append(actions.cpu())
            return step(ps, actions, env_ids)

        pool.step = recording_step
        cfg = PPOConfig(total_steps=2 * 8 * n, num_steps=8, epochs=1,
                        minibatches=2)
        state, _, history = driver(pool, cfg, seed=SEED, hidden=(32, 32))
        runs[dev] = (torch.stack(acts), history,
                     {p: x.cpu() for p, x in
                      tree_leaves_with_path(state.params)})
    (g_acts, g_hist, g_par), (c_acts, c_hist, c_par) = runs[DEV], runs["cpu"]
    if atol is None:
        ok = torch.equal(g_acts, c_acts)
    else:
        ok = torch.allclose(g_acts, c_acts, rtol=0, atol=atol)
    if not ok:
        raise AssertionError(f"{name} {task}: actions differ between cuda "
                             "and cpu")
    eps = [r["episodes"] for r in c_hist]
    if [r["episodes"] for r in g_hist] != eps or sum(eps) == 0:
        raise AssertionError(f"{name} {task}: episodes differ between cuda "
                             "and cpu, or none ended")
    for g, c in zip(g_hist, c_hist):
        for k in ("loss", "pg", "vf", "ent", "ratio") + (
                ("rho_behavior",) if pipelined else ()):
            # pg is a mean of terms of size 1 that cancel to 1e-4
            tol = 1e-5 if k == "pg" else 1e-4 * abs(c[k]) + 1e-6
            if abs(g[k] - c[k]) > tol:
                raise AssertionError(f"{name} {task} iter {c['iter']}: {k} "
                                     f"{g[k]} on cuda, {c[k]} on cpu")
    err = max(float((g_par[p] - c_par[p]).abs().max()) for p in c_par)
    if err > 1e-5:
        raise AssertionError(f"{name} {task}: params differ by {err} > 1e-5")
    log(f"  {name} {task} N={n}, 2 iterations of 1 x 2 minibatches: "
        "cuda == cpu actions"
        + (" (bitwise)" if atol is None else f" (within {atol})")
        + f", episodes {eps}, losses within 1e-4, params within 1e-5 "
        f"(max abs err {err})")


def cross_check_model(arch: str, prompt_len: int = 64, **overrides
                      ) -> None:
    """The f32 smoke config of ``arch`` (``overrides`` on top) on
    ``cuda`` and on ``cpu`` from the same weights: ``Model.prefill``
    with the blocked branch (a ``prompt_len``-position prompt filling
    the cache: one flash launch a layer on the card and no copy, but in
    the xLSTM, which has no attention, and Whisper, which runs ``mha``;
    a vlm's patch embeddings before its tokens; Whisper's frames
    encoded first; a hybrid's or the xLSTM's prompt whole chunks of 8)
    and 8 greedy ``decode_step``s (a vlm's at (B, 1, 3) positions; the
    steps write the cache's last slot, clamped as
    ``dynamic_update_slice`` clamps, the same on both devices):
    identical tokens, logits within 1e-4; then one ``train_loss`` and
    its backward on a ``synth_batch`` train cell of ``prompt_len``
    positions: the loss within 1e-5, each gradient leaf within 1e-4 of
    its largest entry."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import loss_and_grads, synth_batch
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    cfg = get_smoke_config(arch).replace(
        compute_dtype=torch.float32, attn_impl="blocked", **overrides)
    cpu = build_model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 5)
    train = synth_batch(cpu, ShapeSpec("t", "train", prompt_len, 2), gen)
    prompt = synth_batch(cpu, ShapeSpec("p", "prefill", prompt_len, 2), gen)
    if cfg.family == "vlm":       # the train cell's patches, then text
        P = train["patch_embeds"].shape[1]
        prompt = {"patch_embeds": train["patch_embeds"],
                  "tokens": prompt["tokens"][:, P:],
                  "positions": train["positions"]}
    runs = {}
    for dev in (DEV, "cpu"):
        model = build_model(cfg, dev)
        p = tree_map(lambda x: x.to(dev), params)
        before, copies = flash_attention.launches, flash_attention.copies
        logits, cache = model.prefill(
            p, {k: v.to(dev) for k, v in prompt.items()},
            max_len=prompt_len)
        flash = flash_attention.launches - before
        toks, logs = [], [logits.cpu()]
        for t in range(8):
            nxt = logits.argmax(-1).to(torch.int32)
            toks.append(nxt.cpu())
            pos = None
            if cfg.family == "vlm":
                pos = torch.full((2, 1, 3), prompt_len + t,
                                 dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(p, nxt[:, None], cache,
                                              positions=pos)
            logs.append(logits.cpu())
        loss, _, grads = loss_and_grads(model, p, {
            k: v.to(dev) for k, v in train.items()})
        runs[dev] = (torch.stack(toks), torch.stack(logs), float(loss),
                     {k: g.cpu() for k, g in tree_leaves_with_path(grads)})
        want = 0 if cfg.family in ("ssm", "encdec") else cfg.n_layers
        if dev == DEV and (flash != want
                           or flash_attention.copies != copies):
            raise AssertionError(f"{arch}: the card's prefill launched "
                                 f"{flash} flash kernels (want {want}), "
                                 f"{flash_attention.copies - copies} "
                                 "copies")
    if not torch.equal(runs[DEV][0], runs["cpu"][0]):
        raise AssertionError(f"{arch}: greedy tokens differ between cuda "
                             "and cpu")
    err = float((runs[DEV][1] - runs["cpu"][1]).abs().max())
    loss_err = abs(runs[DEV][2] - runs["cpu"][2])
    grad_err = max(float((g - runs["cpu"][3][k]).abs().max())
                   / max(float(runs["cpu"][3][k].abs().max()), 1e-30)
                   for k, g in runs[DEV][3].items())
    if err > 1e-4 or loss_err > 1e-5 or grad_err > 1e-4:
        raise AssertionError(f"{arch}: logits differ by {err} (1e-4), the "
                             f"loss by {loss_err} (1e-5), a gradient by "
                             f"{grad_err} of its largest entry (1e-4)")
    log(f"  model {arch} {overrides or ''} blocked prefill + 8 decode "
        f"steps and a train loss + backward: cuda == cpu tokens, logits within 1e-4 (max abs "
        f"err {err}), loss {runs[DEV][2]:.6f} within 1e-5 ({loss_err}), "
        f"gradients within 1e-4 of their largest entry ({grad_err})")


def cross_check_lm_train(arch: str = "qwen3-0.6b", **overrides) -> None:
    """Three ``make_train_step`` steps of the f32 smoke config of
    ``arch`` with the blocked branch (``overrides`` on top), on ``cuda``
    and on ``cpu`` from the same weights and ``SyntheticSource`` batches
    (B=4, S=64): losses and ``aux`` (an MoE config's routers' loss)
    within 1e-5, and on the card ``flash_per_step`` flash_attention
    launches a step (the forward's, and the recompute's at the default
    ``remat="full"``; the attention's backward is the plain version) and
    no copy."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import BatchSpec, SyntheticSource
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.utils.tree import tree_map

    cfg = get_smoke_config(arch).replace(
        compute_dtype=torch.float32, attn_impl="blocked", **overrides)
    opt = adamw(weight_decay=0.01)
    start = init_train_state(build_model(cfg, "cpu"), opt,
                             torch.Generator().manual_seed(SEED))
    src = SyntheticSource(cfg.vocab, branching=8, seed=1)
    batches = [src.batch(BatchSpec(4, 64, cfg.vocab), t) for t in range(3)]
    losses = {}
    for dev in (DEV, "cpu"):
        step = make_train_step(build_model(cfg, dev), opt,
                               linear_warmup_cosine(1e-2, 1, 3))
        state = tree_map(lambda x: x.to(dev), start)
        before, copies = flash_attention.launches, flash_attention.copies
        losses[dev] = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in b.items()})
            losses[dev] += [float(m["loss"]), float(m["aux"])]
        want = len(batches) * flash_per_step(cfg)
        if dev == DEV and (flash_attention.launches - before != want
                           or flash_attention.copies != copies):
            raise AssertionError(
                f"LM train {arch} {overrides}: "
                f"{flash_attention.launches - before} flash launches in "
                f"{len(batches)} steps (want {want}),"
                f" {flash_attention.copies - copies} copies")
    if (cfg.moe is not None) != (losses["cpu"][1] > 0.0):
        raise AssertionError(f"LM train {arch}: aux {losses['cpu'][1::2]}")
    err = max(abs(a - b) for a, b in zip(losses[DEV], losses["cpu"]))
    if err > 1e-5:
        raise AssertionError(f"LM train {arch} {overrides}: losses or aux "
                             f"differ by {err} > 1e-5: {losses}")
    log(f"  LM train step, f32 smoke {arch} blocked {overrides or ''}: "
        f"cuda == cpu, 3 steps, losses {losses[DEV][::2]} and aux "
        f"{losses[DEV][1::2]} within 1e-5 (max abs err {err}), "
        f"{flash_per_step(cfg)} flash launches a step ({cfg.remat})")


# ---------------------------------------------------------------------- #
# phase 6: the sharded engine on the card
# ---------------------------------------------------------------------- #
RANK_N = 4096         # Ant-v3 lanes of the two-rank rows
RANK_RECVS = 20       # recvs of the two-rank stream
RANK_ITERS = 2        # iterations of train_disaggregated
# train_device with PongClassic-v5's default CNN (1,687,719 params, past
# policy_shardings' 2^20: 11 of its 12 leaves sharded over the 2 shards),
# PPOConfig's defaults, the last iteration timed
RANK_CNN_N, RANK_CNN_ITERS = 256, 2
CNN_PARAMS, CNN_HALF = 1_687_719, 843_860
# the LM policy collect across the ranks: TokenRagged-v0 N/M, greedy
# recvs, and the lm-policy widened past 2^20 params
# (tests/_torch_mesh_check.py's width)
RANK_LM_N, RANK_LM_M, RANK_LM_STEPS, RANK_LM_LEN = 64, 32, 8, 16
RANK_LM_WIDTH = {"d_model": 256, "d_ff": 1024, "head_dim": 64}


def sorted_blocks(pool, tables, steps: int) -> list:
    """``steps`` blocks of ``pool`` from the seed's reset, each field's
    rows in env-id order, on the host."""
    import repro_torch

    ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
    out = []
    for t in range(steps):
        order = ts.env_id.argsort()
        out.append({k: getattr(ts, k)[order].cpu() for k in (
            "env_id", "obs", "reward", "done", "episode_return",
            "step_cost")})
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
    return out


def check_mesh_invariance(task: str, n: int, shards: int,
                          atol: float | None = None, steps: int = 6
                          ) -> dict:
    """The first ``steps`` sync blocks at D=``shards`` against the same
    pool at D=1, both on the card, rows aligned by env id: bitwise, but
    a ``NormalizeObs`` pool's obs (``atol``), whose block sums run in
    another order at each D."""
    import torch

    import repro_torch

    pools = [repro_torch.make(task, num_envs=n, engine="device-sharded",
                              num_shards=d, device=DEV)
             for d in (1, shards)]
    tables = action_tables(pools[0], 8, np.random.default_rng(SEED))
    one, many = (sorted_blocks(p, tables, steps) for p in pools)
    err = 0.0
    for t, (a, b) in enumerate(zip(one, many)):
        for k in a:
            if k == "obs" and atol is not None:
                err = max(err, float((a[k] - b[k]).abs().max()))
                if err > atol:
                    raise AssertionError(f"{task} D={shards} block {t}: "
                                         f"obs off by {err} > {atol}")
            elif not torch.equal(a[k], b[k]):
                raise AssertionError(f"{task} D={shards} block {t}: {k} "
                                     "differs from D=1")
    row = {"task": task, "num_envs": n, "num_shards": shards,
           "blocks": steps, "bitwise": atol is None,
           "obs_max_abs_err": err if atol is not None else 0.0}
    log(f"  {task} N={n} D={shards} == D=1 on the card, {steps} blocks "
        + ("bitwise" if atol is None else f"(obs within {err:.3g})"))
    return row


def rank_stream(task: str, n: int, recvs: int) -> dict:
    """A sync stream of the sharded engine at D=2 over the mesh this
    process sees (solo: both shards here; in a job of two: one a rank):
    the sha256 of every block as the whole mesh holds it, ``stats()``,
    and the ms a recv of a second run without the host reads."""
    import hashlib

    import torch

    import repro_torch
    from repro_torch.obs.telemetry import stats_to_jsonable

    pool = repro_torch.make(task, num_envs=n, engine="device-sharded",
                            num_shards=2, device=DEV)
    tables = action_tables(pool, 8, np.random.default_rng(SEED))
    ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
    sha = hashlib.sha256()
    for t in range(recvs):
        for x in pool.replicate((ts.obs, ts.reward, ts.done, ts.env_id)):
            sha.update(x.cpu().numpy().tobytes())
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
    stats = stats_to_jsonable(pool.stats(ps))
    torch.cuda.synchronize()
    pool.mesh.reset_log()
    t0 = time.perf_counter()
    for t in range(recvs):
        ps, ts = pool.step(ps, tables[t % 8][ts.env_id.long()], ts.env_id)
    torch.cuda.synchronize()
    return {"sha": sha.hexdigest(), "stats": stats,
            "block": int(ts.env_id.shape[0]),
            "ms_per_recv": (time.perf_counter() - t0) / recvs * 1e3,
            "collectives_per_recv": len(pool.mesh.log) / recvs}


def drive_disaggregated(n: int, iters: int) -> dict:
    """``train_disaggregated`` on Ant-v3 N=``n`` with ``PPOConfig``'s
    defaults, the env process holding two shards and the learner none:
    ms per iteration (the first includes the reset and the first
    rollout) and the seconds each iteration spent in ``host_broadcast``
    (the hand-off, waiting for the other side included)."""
    import torch

    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.rl.ppo import PPOConfig, train_disaggregated
    from repro_torch.utils.tree import tree_leaves

    mesh = sharding.disaggregated_env_mesh(2, device=DEV)
    pool = repro_torch.make("Ant-v3", num_envs=n, engine="device-sharded",
                            mesh=mesh)
    cfg = PPOConfig(total_steps=iters * 128 * n)
    broadcast = sharding.host_broadcast
    handoff = []

    def timed(tree, src):
        t = time.perf_counter()
        out = broadcast(tree, src)
        handoff.append(time.perf_counter() - t)
        return out

    ends = []
    sharding.host_broadcast = timed
    t0 = time.perf_counter()
    try:
        state, _, history = train_disaggregated(
            pool, cfg, seed=SEED, log_fn=lambda r: ends.append(
                time.perf_counter()))
    finally:
        sharding.host_broadcast = broadcast
    for leaf in tree_leaves(state.params):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("train_disaggregated: params not finite")
    for rec in history:
        if not all(np.isfinite(rec[k]) for k in ("loss", "pg", "vf",
                                                 "rho_behavior")):
            raise AssertionError(f"train_disaggregated: {rec}")
    laps = np.diff([t0] + ends) * 1e3
    return {"local_shards": mesh.local_shards,
            "ms_per_iter": laps.tolist(),
            # one broadcast of the initial params, then two an iteration
            "handoff_ms_per_iter": [
                (handoff[1 + 2 * i] + handoff[2 + 2 * i]) * 1e3
                for i in range(iters)],
            "rollout_ms": [handoff[1 + 2 * i] * 1e3 for i in range(iters)],
            "params_ms": [handoff[2 + 2 * i] * 1e3 for i in range(iters)],
            "history": [{k: r[k] for k in ("iter", "loss", "pg", "vf",
                                           "rho_behavior", "episodes")}
                        for r in history]}


def tree_bytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def halves_net(base):
    """``base`` (``ActorCritic``) with ``sample``'s forward run in two
    calls of half the rows each: the arithmetic of two ranks' collects,
    each on its own M/2 rows, in one process."""

    class Halves(base):
        def sample(self, p, obs, key, rows=None):
            import torch

            forward = self.forward

            def split(p, obs):
                outs = [forward(p, h) for h in obs.chunk(2)]
                return tuple(torch.cat(o) for o in zip(*outs))

            self.forward = split
            try:
                return super().sample(p, obs, key, rows)
            finally:
                del self.forward

    return Halves


def cnn_train(n: int, iters: int, out: str | None = None,
              halves: bool = False, deterministic: bool = True) -> dict:
    """``train_device`` over PongClassic-v5 N=``n`` at D=2 with the
    default CNN, ``PPOConfig``'s defaults, ``iters`` iterations, the
    last timed: the bytes of the params this process held (as handed to
    ``gather_policy``) and of its AdamW moments, the ``"policy"``
    gathers of each iteration (``EnvMesh.log``), ms per iteration and
    the path's launches; the final params, whole, go to ``out`` (an
    ``.npz``) or into the row (``final``).  ``halves``: the collect's
    forward in two calls of M/2 rows (``halves_net``), as the two
    ranks run it.  ``deterministic``: cuDNN's deterministic algorithms
    (its default ones are not: ``cnn_witness``)."""
    import torch

    import repro_torch
    import repro_torch.rl.ppo as tppo
    from repro_torch.kernels.backend import launch_counts
    from repro_torch.utils.tree import tree_leaves_with_path

    pool = repro_torch.make("PongClassic-v5", num_envs=n,
                            engine="device-sharded", num_shards=2,
                            device=DEV)
    cfg = tppo.PPOConfig(total_steps=iters * 128 * n)
    held, gathers, ends = [], [], []
    gather, net = tppo.gather_policy, tppo.ActorCritic

    def recorded(mesh, local, plan):
        held.append(tree_bytes(local))
        return gather(mesh, local, plan)

    def logged(rec):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        gathers.append(pool.mesh.counts().get("policy", 0))

    before = launch_counts()
    torch.cuda.synchronize()
    tppo.gather_policy = recorded
    if halves:
        tppo.ActorCritic = halves_net(net)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    t0 = time.perf_counter()
    try:
        state, _, history = tppo.train_device(pool, cfg, seed=SEED,
                                              log_fn=logged)
    finally:
        tppo.gather_policy, tppo.ActorCritic = gather, net
        torch.backends.cudnn.deterministic = was
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    params = {path: x.cpu().numpy() for path, x in
              tree_leaves_with_path(state.params)}
    for path, x in params.items():
        if not np.isfinite(x).all():
            raise AssertionError(f"cnn train_device: {path} not finite")
    laps = np.diff([t0] + ends) * 1e3
    row = {"task": "PongClassic-v5", "num_envs": n, "num_shards": 2,
           "iterations": iters,
           "epochs_x_minibatches": cfg.epochs * cfg.minibatches,
           "params": sum(x.size for x in params.values()),
           "held_param_bytes": held[0] if held else tree_bytes(
               state.params),
           "moment_bytes": tree_bytes((state.opt.mu, state.opt.nu)),
           "whole_bytes": 3 * tree_bytes(state.params),
           "policy_gathers_per_iter": np.diff([0] + gathers).tolist(),
           "ms_per_iter": laps.tolist(), "launches": launches,
           "loss": [r["loss"] for r in history]}
    row["placed_bytes"] = row["held_param_bytes"] + row["moment_bytes"]
    if out is None:
        row["final"] = params
    else:
        np.savez(out, **params)
    return row


def rank_lm_policy() -> dict:
    """The LM policy's greedy collect on TokenRagged-v0 at D=2, the
    lm-policy widened past 2^20 params (weights from a seeded generator
    on this process's device), placed by ``place_params`` and whole:
    the whole mesh's actions of each, equal; the bytes held placed and
    whole; ``decode_attention``'s launches."""
    import hashlib

    import torch

    import repro_torch
    from repro_torch.kernels.backend import launch_counts
    from repro_torch.rl.policy_lm import (
        LMPolicy,
        build_lm_collect_fn,
        default_policy_config,
    )
    from repro_torch.utils.tree import tree_leaves

    pool = repro_torch.make("TokenRagged-v0", num_envs=RANK_LM_N,
                            batch_size=RANK_LM_M, engine="device-sharded",
                            num_shards=2, device=DEV)
    vocab = int(pool.spec.act_spec.maximum) + 1
    cfg = default_policy_config(vocab, RANK_LM_LEN).replace(**RANK_LM_WIDTH)
    pol = LMPolicy(pool.spec, cfg, max_len=RANK_LM_LEN, device=DEV)
    params = pol.init(torch.Generator(device=DEV).manual_seed(SEED))
    placed = pol.place_params(params, pool)
    before = launch_counts()
    acts = []
    for p in (placed, params):
        collect = build_lm_collect_fn(pool, pol, RANK_LM_STEPS, greedy=True)
        ps, ts = pool.reset(repro_torch.random.PRNGKey(SEED))
        *_, a = collect(ps, pol.init_lanes(RANK_LM_N), p, ts,
                        repro_torch.random.PRNGKey(SEED + 1, device=DEV))
        acts.append(pool.mesh.gather(a, "actions", dim=1).cpu())
    if not torch.equal(acts[0], acts[1]):
        raise AssertionError("lm policy: placed and whole actions differ")
    return {"params": sum(x.numel() for x in tree_leaves(params)),
            "held_bytes": tree_bytes(placed),
            "whole_bytes": tree_bytes(params),
            "actions_sha": hashlib.sha256(
                acts[0].numpy().tobytes()).hexdigest(),
            "decode_launches": launch_counts()["decode_attention"]
            - before["decode_attention"]}


def rank_main(argv: list[str]) -> int:
    """``chip_smoke.py rank <process id> <port> <device> <lanes> <dir>``:
    one of the two processes of the ranks rows, joined over gloo on
    localhost, both on the same card: the D=2 stream,
    ``train_disaggregated``, ``train_device`` with the CNN sharded across
    the two (its final params to ``<dir>/rank<id>.npz``) and the LM
    policy placed across the two; prints one JSON line."""
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.launch.mesh import initialize_multihost

    global DEV
    pid, port, DEV, n, out = (int(argv[0]), argv[1], argv[2],
                              int(argv[3]), argv[4])
    if DEV.startswith("cuda"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        from repro_torch.kernels.build import library

        library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:   # a rehearsal on the CPU: nothing to wait for
        torch.cuda.synchronize = lambda *a, **k: None
    initialize_multihost(f"localhost:{port}", 2, pid, backend="gloo")
    reset_counts()
    out = {"pid": pid, "stream": rank_stream("Ant-v3", n, RANK_RECVS),
           "disaggregated": drive_disaggregated(n, RANK_ITERS),
           "cnn": cnn_train(RANK_CNN_N, RANK_CNN_ITERS,
                            os.path.join(out, f"rank{pid}.npz")),
           "lm_policy": rank_lm_policy()}
    out["launches"] = {k: fn.launches for k, fn in counters().items()}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def ranks_phase() -> dict:
    """Two processes sharing the card over gloo, spawned here: their D=2
    Ant-v3 N=4096 stream and ``stats()`` must equal this process's solo
    D=2 run, compared by hash; then ``train_disaggregated`` with one env
    rank and one learner rank, ``RANK_ITERS`` iterations; then
    ``train_device`` with PongClassic-v5's CNN sharded across the two
    against solo's (``check_cnn_ranks``); and the LM policy placed
    across the two collecting solo's actions."""
    import socket
    import tempfile

    solo = rank_stream("Ant-v3", RANK_N, RANK_RECVS)
    solo_cnn = cnn_train(RANK_CNN_N, RANK_CNN_ITERS, halves=True)
    solo_lm = rank_lm_policy()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "rank", str(i), port,
             DEV, str(RANK_N), tmp], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in (0, 1)]
        outs = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"rank failed ({p.returncode}): "
                                         f"{stderr[-3000:]}")
                outs.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        finals = [dict(np.load(os.path.join(tmp, f"rank{i}.npz")))
                  for i in (0, 1)]
    for r in outs:
        got = r["stream"]
        if got["sha"] != solo["sha"] or got["stats"] != solo["stats"]:
            raise AssertionError(f"rank {r['pid']}: stream or stats() "
                                 "differ from solo D=2")
        if 2 * got["block"] != solo["block"]:
            raise AssertionError(f"rank {r['pid']}: block {got['block']}")
    env, learner = (r["disaggregated"] for r in outs)
    if env["history"] != learner["history"] or (
            env["local_shards"], learner["local_shards"]) != (2, 0):
        raise AssertionError("train_disaggregated: ranks disagree")
    if outs[0]["launches"]["env_step"] == 0 and DEV.startswith("cuda"):
        raise AssertionError("train_disaggregated: env_step never launched")
    cnn = check_cnn_ranks(solo_cnn, outs, finals)
    lm = [r["lm_policy"] for r in outs]
    for r in lm:
        if r["actions_sha"] != solo_lm["actions_sha"] or not (
                r["whole_bytes"] / 2 <= r["held_bytes"] < r["whole_bytes"]):
            raise AssertionError(f"lm policy across ranks: {r} against "
                                 f"solo {solo_lm}")
        if DEV.startswith("cuda") and r["decode_launches"] == 0:
            raise AssertionError("lm policy: decode_attention never "
                                 "launched")
    launches = {k: sum(r["launches"][k] for r in outs)
                + solo_cnn["launches"][k] for k in outs[0]["launches"]}
    row = {"ranks": 2, "backend": "gloo", "seconds":
           time.perf_counter() - t0, "stream_sha_equal": True,
           "solo_ms_per_recv": solo["ms_per_recv"],
           "rank_ms_per_recv": [r["stream"]["ms_per_recv"] for r in outs],
           "solo_collectives_per_recv": solo["collectives_per_recv"],
           "rank_collectives_per_recv": [r["stream"]["collectives_per_recv"]
                                         for r in outs],
           "disaggregated": {"env": env, "learner": learner},
           "cnn": cnn, "lm_policy": {"solo": solo_lm, "ranks": lm},
           "launches": launches}
    log(f"  ranks: 2 processes on one card over gloo: Ant-v3 N={RANK_N} D=2 "
        f"sync, {RANK_RECVS} blocks and stats() equal solo's by hash; "
        f"{row['rank_ms_per_recv']} ms/recv against solo's "
        f"{solo['ms_per_recv']:.2f}; train_disaggregated Ant-v3 N={RANK_N} "
        f"{RANK_ITERS} iterations: ms/iter env {env['ms_per_iter']} "
        f"learner {learner['ms_per_iter']}, hand-off ms env "
        f"{env['handoff_ms_per_iter']} (rollout {env['rollout_ms']}) "
        f"learner {learner['handoff_ms_per_iter']}; {CARD}")
    log(f"  ranks: LM policy of {solo_lm['params']} params placed across "
        f"the 2: {[r['held_bytes'] for r in lm]} bytes a rank of "
        f"{solo_lm['whole_bytes']}, {RANK_LM_STEPS} greedy recvs equal "
        f"solo's; decode_attention launches "
        f"{[r['decode_launches'] for r in lm]}")
    return row


def check_cnn_ranks(solo: dict, outs: list[dict], finals: list[dict]
                    ) -> dict:
    """The ranks' ``train_device`` rows with the CNN sharded across them
    against solo's at D=2, whose collect runs its forward in the ranks'
    two halves (``halves_net``: the one thing a rank's arithmetic does
    otherwise; at M rows in one call cuDNN and cuBLAS round apart, and
    AdamW turns that rounding into steps of up to lr where a gradient
    is all but 0: ``cnn_witness``).  Gated: the bytes each rank placed,
    exactly half of every sharded leaf; ``1 + epochs * minibatches``
    policy gathers an iteration (none solo); the path's kernels
    launched; each leaf of each rank's final params within 1e-4 of its
    largest magnitude of solo's, the losses within 1e-4 relative."""
    want_gathers = [1 + solo["epochs_x_minibatches"]] * RANK_CNN_ITERS
    whole = 3 * 4 * CNN_PARAMS
    if solo["params"] != CNN_PARAMS or solo["placed_bytes"] != whole \
            or solo["policy_gathers_per_iter"] != [0] * RANK_CNN_ITERS:
        raise AssertionError(f"cnn solo: {solo}")
    ranks = [r["cnn"] for r in outs]
    solo_diff = {}
    for r, final in zip(ranks, finals):
        if r["placed_bytes"] != 3 * 4 * CNN_HALF or r["whole_bytes"] != whole:
            raise AssertionError(f"cnn rank placed {r['placed_bytes']} "
                                 f"bytes of {r['whole_bytes']}, want "
                                 f"{3 * 4 * CNN_HALF} of {whole}")
        if r["policy_gathers_per_iter"] != want_gathers:
            raise AssertionError(f"cnn rank policy gathers "
                                 f"{r['policy_gathers_per_iter']}, want "
                                 f"{want_gathers}")
        if DEV.startswith("cuda"):
            read = {k: r["launches"][k] for k in ("pong_render",
                                                   "grayscale", "resize")}
            if not all(read.values()):
                raise AssertionError(f"cnn rank launches {read}")
        for k, want in solo["final"].items():
            peak = max(float(np.abs(want).max()), 1e-30)
            solo_diff[k] = max(solo_diff.get(k, 0.0), float(np.abs(
                final[k] - want).max()) / peak)
    loss_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["loss"], solo["loss"]))
    param_rel = max(solo_diff.values())
    out = {"params": CNN_PARAMS, "placed_bytes": [r["placed_bytes"]
                                                  for r in ranks],
           "whole_bytes": whole,
           "policy_gathers_per_iter": [r["policy_gathers_per_iter"]
                                       for r in ranks],
           "max_rel_param_diff_vs_solo": param_rel,
           "max_rel_loss_diff_vs_solo": loss_rel,
           "rel_param_diff_vs_solo": solo_diff,
           "rank_ms_per_iter": [r["ms_per_iter"] for r in ranks],
           "solo_ms_per_iter": solo["ms_per_iter"],
           "rank_launches": [{k: r["launches"][k] for k in (
               "pong_render", "grayscale", "resize")} for r in ranks],
           "solo_launches": {k: solo["launches"][k] for k in (
               "pong_render", "grayscale", "resize")},
           "loss": {"solo": solo["loss"], "ranks": [r["loss"]
                                                    for r in ranks]}}
    log(f"  ranks: train_device PongClassic-v5 N={RANK_CNN_N} D=2 with the "
        f"CNN sharded across the 2: {out['placed_bytes']} bytes of params "
        f"+ mu + nu a rank against {whole} whole; policy gathers an "
        f"iteration {out['policy_gathers_per_iter']} (1 + epochs x "
        f"minibatches); against solo's (its collect forward in the ranks' "
        f"halves) final params off by {param_rel:.3g} of a leaf's largest "
        f"magnitude ({solo_diff}), losses by {loss_rel:.3g} relative; "
        f"ms/iter ranks {out['rank_ms_per_iter']}, solo "
        f"{solo['ms_per_iter']}; render/grayscale/resize launches ranks "
        f"{out['rank_launches']} solo {out['solo_launches']}; {CARD}")
    if not (param_rel <= 1e-4 and loss_rel <= 1e-4):
        raise AssertionError(f"cnn: ranks against solo: params {param_rel}, "
                             f"losses {out['loss']}")
    return out


def cnn_witness(argv: list[str]) -> int:
    """``chip_smoke.py cnn_witness``: phase 6's solo CNN run
    (``cnn_train``) four times in one process: with cuDNN's
    deterministic algorithms at M rows a forward and in the ranks' two
    halves, and twice with its default algorithms; prints each pair's
    largest difference of a leaf's final params over its largest
    magnitude, and of the losses, as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.kernels.build import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = card_line()
    library()
    runs = {"one_call": cnn_train(RANK_CNN_N, RANK_CNN_ITERS),
            "halves": cnn_train(RANK_CNN_N, RANK_CNN_ITERS, halves=True),
            "default_a": cnn_train(RANK_CNN_N, RANK_CNN_ITERS,
                                   deterministic=False),
            "default_b": cnn_train(RANK_CNN_N, RANK_CNN_ITERS,
                                   deterministic=False)}

    def apart(a: dict, b: dict) -> dict:
        params = {k: float(np.abs(a["final"][k] - w).max())
                  / max(float(np.abs(w).max()), 1e-30)
                  for k, w in b["final"].items()}
        return {"params": params, "max_param": max(params.values()),
                "max_loss": max(abs(x - y) / abs(y) for x, y in
                                zip(a["loss"], b["loss"]))}

    out = {"card": CARD, "task": "PongClassic-v5", "num_envs": RANK_CNN_N,
           "one_call_vs_halves": apart(runs["one_call"], runs["halves"]),
           "default_vs_default": apart(runs["default_a"], runs["default_b"]),
           "ms_per_iter": {k: r["ms_per_iter"] for k, r in runs.items()},
           "loss": {k: r["loss"] for k, r in runs.items()}}
    print(json.dumps(out))
    return 0


def drive_sharded_train(n: int = 4096, shards: int = 2, iters: int = 2
                        ) -> dict:
    """``train_device`` over a solo D=``shards`` Ant-v3 pool,
    ``PPOConfig``'s defaults, ``iters`` iterations; the last timed."""
    import torch

    import repro_torch
    from repro_torch.rl.ppo import PPOConfig, train_device
    from repro_torch.utils.tree import tree_leaves

    pool = repro_torch.make("Ant-v3", num_envs=n, engine="device-sharded",
                            num_shards=shards, device=DEV)
    cfg = PPOConfig(total_steps=iters * 128 * n)
    ends = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, _, history = train_device(
        pool, cfg, seed=SEED, log_fn=lambda r: ends.append(
            time.perf_counter()))
    launches = read_counts("train_device sharded", ("env_step",))
    for leaf in tree_leaves(state.params):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("train_device sharded: params not finite")
    laps = np.diff([t0] + ends) * 1e3
    row = {"driver": "train_device", "task": "Ant-v3", "num_envs": n,
           "num_shards": shards, "iterations": iters,
           "ms_per_iter": laps.tolist(),
           "env_steps_per_s": 128 * n / laps[-1] * 1e3,
           "launches": launches,
           "loss": [r["loss"] for r in history]}
    log(f"  train_device over Ant-v3 N={n} D={shards}: {laps.tolist()} "
        f"ms/iter, {row['env_steps_per_s']:.0f} env steps/s, launches "
        f"{launches}; {CARD}")
    return row


def sharded_phase() -> dict:
    """Phase 6: the solo pools on the card, their D=1 equality, the two
    ranks and ``train_device`` over a solo pool."""
    ant = ("env_step",)
    pong = ("pong_render", "grayscale", "resize")
    rows = [
        drive_pool("Ant-v3", 4096, None, "fifo", ant, recvs=50, shards=4),
        drive_pool("Ant-v3", 4096, 2048, "fifo", ant, recvs=50, shards=4),
        drive_pool("Ant-v3", 4096, 2048, "hierarchical", ant, recvs=50,
                   shards=4),
        drive_pool("AntSkew-v3", 4096, 2048, "hierarchical", ant,
                   recvs=100, shards=4),
        drive_pool("PongClassic-v5", 1024, None, "fifo", pong, recvs=30,
                   shards=2),
        drive_pool("AntNorm-v3", 4096, None, "fifo", ant, recvs=50,
                   shards=2),
    ]
    checks = [check_mesh_invariance("Ant-v3", 4096, 4),
              check_mesh_invariance("PongClassic-v5", 1024, 2),
              check_mesh_invariance("AntNorm-v3", 4096, 2, atol=1e-3)]
    return {"pools": rows, "mesh_invariance": checks,
            "ranks": ranks_phase(), "train": drive_sharded_train()}


# ---------------------------------------------------------------------- #
# phase 7: the LM trainer on the card
# ---------------------------------------------------------------------- #
def flash_per_step(cfg) -> int:
    """Flash launches a train step of ``cfg`` (blocked): one a layer in
    the forward, and one more in the backward's recompute of each layer
    unless ``remat="none"`` (``models/remat.py``)."""
    return cfg.n_layers * (1 if cfg.remat == "none" else 2)


def annotated_kernel_ms(prof, name: str) -> float | None:
    """Device ms of the kernels launched inside ``record_function(name)``
    ranges of ``prof``: the CPU events that start inside a range give
    their correlation ids, the CUDA kernels that carry one of them (as
    their own or linked id) add up.  None when the profiler saw no such
    range or no kernel in one."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == DeviceType.CPU
                   and e.name() == name)
    if not spans:
        return None
    ids = {e.correlation_id() for e in events
           if e.device_type() == DeviceType.CPU and e.name() != name
           and any(a <= e.start_ns() <= b for a, b in spans)} - {0}
    ns = [e.duration_ns() for e in events
          if e.device_type() == DeviceType.CUDA and not user_annotation(e)
          and (e.correlation_id() in ids or e.linked_correlation_id() in ids)]
    return sum(ns) / 1e6 if ns else None


def drive_lm_train(warmup: int = 2, timed: int = 5) -> dict:
    """``make_train_step`` on ``TRAIN_MODEL`` at full width on the card:
    ``attn_impl="blocked"``, f32 parameters, bf16 compute, AdamW (weight
    decay 0.01, lr 3e-4 after 2 warm-up steps), ``SyntheticSource``
    batches of ``TRAIN_B`` x ``TRAIN_S``, the weights from a seeded
    generator on the card, ``remat="full"`` (the default).  ``warmup``
    steps, ``timed`` timed ones (``flash_per_step`` flash_attention
    launches a step: a layer's forward and its recompute; no copy), one
    under
    ``torch.profiler`` (device busy, idle share, top kernel families, the
    device ms of the plain attention backward: its ``record_function``
    ranges); the plain backward also timed alone at the step's shape.
    Every loss and every gradient leaf finite, the attention weights'
    gradients non-zero in every layer (they reach wq, wk, wv, q_norm and
    k_norm only through the kernel's call), every parameter changed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import BatchSpec, SyntheticSource
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         plain_grads)
    from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params, model_flops_per_token
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    cfg = get_config(TRAIN_MODEL, attn_impl="blocked")
    model = build_model(cfg, DEV)
    opt = adamw(weight_decay=0.01)
    state = init_train_state(model, opt,
                             torch.Generator(device=DEV).manual_seed(SEED))
    params0 = state.params
    n_steps = warmup + timed + 1
    step = make_train_step(model, opt,
                           linear_warmup_cosine(3e-4, 2, n_steps))
    src = SyntheticSource(cfg.vocab, branching=8, seed=1)
    spec = BatchSpec(TRAIN_B, TRAIN_S, cfg.vocab)
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in src.batch(spec, t).items()}
               for t in range(n_steps)]
    losses = []
    for t in range(warmup):
        state, m = step(state, batches[t])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    copies = flash_attention.copies
    reset_counts()
    t0 = time.perf_counter()
    for t in range(warmup, warmup + timed):
        state, m = step(state, batches[t])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(f"train {cfg.name}", ("flash_attention",))
    peak = torch.cuda.max_memory_allocated()
    if launches["flash_attention"] != timed * flash_per_step(cfg) \
            or flash_attention.copies != copies:
        raise AssertionError(
            f"train {cfg.name}: {launches['flash_attention']} flash launches "
            f"in {timed} steps (want {timed * flash_per_step(cfg)}), "
            f"{flash_attention.copies - copies} copies")
    ms = dt / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[-1])
        losses.append(m["loss"])
        torch.cuda.synchronize()
    dev_prof = device_summary(prof, 1, "step")
    bwd_ms = annotated_kernel_ms(prof, "flash_attention.backward")
    del prof
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {cfg.name}: losses {losses}")
    changed = [not torch.equal(a, b) for a, b in
               zip(tree_leaves(params0), tree_leaves(state.params))]
    if not all(changed):
        raise AssertionError(f"train {cfg.name}: {changed.count(False)} "
                             "parameter leaves did not change")
    del params0
    _, _, grads = loss_and_grads(model, state.params, batches[0])
    for path, g in tree_leaves_with_path(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train {cfg.name}: gradient {path} is not "
                                 "finite")
    attn = grads["layers"]["attn"]
    for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
        norms = attn[name].float().flatten(1).norm(dim=1)
        if not bool((norms > 0).all()):
            raise AssertionError(f"train {cfg.name}: the gradient of {name} "
                                 f"is zero in some layer: {norms.tolist()}")
    del grads
    # the plain backward alone at the step's shape: (B, S, H, D) views
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    q, k, v = (torch.randn((TRAIN_B, TRAIN_S, h, cfg.hd), generator=gen,
                           device=DEV).to(cfg.compute_dtype).transpose(1, 2)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    dout = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    bwd_alone = time_ms(lambda: plain_grads(q, k, v, dout, True, 0, None),
                        reps=5, trials=3)
    del q, k, v, dout
    busy = dev_prof["device_busy_ms_per_step"]
    tokens = TRAIN_B * TRAIN_S
    out = {"model": cfg.name, "params": count_params(state.params),
           "attn_impl": cfg.attn_impl, "remat": cfg.remat,
           "batch": TRAIN_B, "seq_len": TRAIN_S,
           "compute_dtype": str(cfg.compute_dtype), "timed_steps": timed,
           "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "model_tflops_per_s":
               model_flops_per_token(cfg) * tokens / ms * 1e-9,
           **analytic_bound(cfg, "train", TRAIN_S, TRAIN_B, ms),
           "flash_launches_per_step": launches["flash_attention"] / timed,
           "flash_copies": flash_attention.copies - copies,
           "losses": losses, "peak_memory_gb": peak / 1e9,
           "device_busy_ms_per_step": busy,
           "kernels_per_step": dev_prof["kernels_per_step"],
           "top3_kernels_ms_per_step": top3(dev_prof, "step"),
           "device_idle_share": None if busy is None else 1.0 - busy / ms,
           "attn_backward_ms_per_step": bwd_ms,
           "attn_backward_share": None if bwd_ms is None else bwd_ms / ms,
           "attn_backward_alone_ms_per_step": bwd_alone * cfg.n_layers,
           "attn_backward_alone_share": bwd_alone * cfg.n_layers / ms,
           "launches": launches, "card": CARD}
    out["analytic_tflops_per_s"] = out["analytic_flops"] / ms * 1e-9
    log(f"  train {cfg.name} blocked B={TRAIN_B} S={TRAIN_S} remat "
        f"{cfg.remat}: "
        f"{out['tokens_per_s']:.0f} tokens/s, {ms:.2f} ms per step, "
        f"{out['model_tflops_per_s']:.1f} model TFLOP/s "
        f"(model_flops_per_token), {out['analytic_tflops_per_s']:.1f} "
        f"analytic TFLOP/s; {bound_text(out)}; flash launches "
        f"per step {out['flash_launches_per_step']}, device busy {busy} ms "
        f"per step (idle share {out['device_idle_share']}), top "
        f"{out['top3_kernels_ms_per_step']}, plain attention backward "
        f"{bwd_ms} ms in the step ({out['attn_backward_share']}), "
        f"{out['attn_backward_alone_ms_per_step']:.2f} ms alone "
        f"({out['attn_backward_alone_share']:.3f}), peak "
        f"{out['peak_memory_gb']:.2f} GB, losses {losses}")
    del state, model, batches
    torch.cuda.empty_cache()
    return out


def drive_lm_cli() -> dict:
    """``python -m repro_torch.launch.train`` on the card as a user runs
    it: ``repro``'s learning criterion (tests/test_system.py's flags: the
    last loss below the first by more than 1.0), and 40 steps straight
    against 20, a restart from their checkpoint and 20 more (the step-39
    loss within rtol 1e-4; the two runs' final parameters compared
    bitwise)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(*flags) -> tuple[list, float]:
        out = os.path.join(tmp, f"h{len(os.listdir(tmp))}.json")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            *flags, "--out-json", out], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"train CLI {flags}: exit {p.returncode}: "
                                 f"{p.stderr[-2000:]}")
        with open(out) as f:
            return json.load(f), time.perf_counter() - t0

    def final_params(ckpt: str) -> dict:
        d = os.path.join(ckpt, "step_40")
        return {n: np.load(os.path.join(d, n)) for n in os.listdir(d)
                if n.startswith(".params") and n.endswith(".npy")}

    try:
        learn, learn_s = run("--arch", "llama3.2-3b", "--smoke", "--d-model",
                             "128", "--layers", "2", "--steps", "150",
                             "--batch", "16", "--seq", "64", "--lr", "3e-3",
                             "--log-every", "25")
        first, last = learn[0]["loss"], learn[-1]["loss"]
        if not last < first - 1.0:
            raise AssertionError(f"train CLI: loss {first} -> {last}, not "
                                 "below the first by more than 1.0")
        small = ("--arch", "qwen3-0.6b", "--smoke", "--d-model", "64",
                 "--layers", "2", "--batch", "4", "--seq", "32",
                 "--log-every", "1", "--ckpt-every", "20")
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        straight, _ = run(*small, "--steps", "40", "--ckpt-dir", a)
        run(*small, "--steps", "20", "--ckpt-dir", b)
        resumed, _ = run(*small, "--steps", "40", "--ckpt-dir", b)
        la = [h["loss"] for h in straight if h["step"] == 39][0]
        lb = [h["loss"] for h in resumed if h["step"] == 39][0]
        if resumed[0]["step"] != 20 or not np.isclose(lb, la, rtol=1e-4,
                                                      atol=0):
            raise AssertionError(f"train CLI restart: step-39 loss {lb} "
                                 f"after a restart, {la} straight")
        pa, pb = final_params(a), final_params(b)
        param_err = max(float(np.abs(pa[n] - pb[n]).max()) for n in pa)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"learn_first_loss": first, "learn_last_loss": last,
           "learn_seconds": learn_s,
           "learn_tokens_per_s": learn[-1]["tokens_per_s"],
           "restart_loss_straight": la, "restart_loss_resumed": lb,
           "restart_params_max_abs_err": param_err,
           "restart_bitwise": param_err == 0.0}
    log(f"  train CLI on the card: llama3.2-3b smoke loss {first} -> {last} "
        f"in 150 steps ({learn_s:.1f} s); restart at 20 of 40: loss {lb} "
        f"against {la} straight, final params max abs err {param_err}")
    return out


# ---------------------------------------------------------------------- #
# phase 8: the model zoo's tooling and the examples
# ---------------------------------------------------------------------- #
# ppo_atari_torch.py's 100 000 default steps, cut to one iteration of its
# 8 lanes x 128 steps (~7 s on the card): async_vs_sync_torch.py's
# defaults alone take 40-50 s, and phase 8 stays within 90 s
PPO_STEPS = 1024
# each example's argv on the card (its defaults but for --device) and a
# field its output must carry
EXAMPLES = [
    ("quickstart_torch", [], "async env steps/s"),
    ("async_vs_sync_torch", [], "tokens/s"),
    ("ppo_atari_torch", ["--total-steps", str(PPO_STEPS)], "env steps/s"),
    ("serve_lm_torch", [], "tok/s"),
    ("sharded_scaleout_torch", [], "steps/s"),
]
# the unified engine's rows held against the parent tree's
ENGINE_ROWS = [("Ant-v3", 4096, ("env_step",)),
               ("PongClassic-v5", 1024, ("pong_render", "grayscale",
                                         "resize"))]


def drive_compression() -> dict:
    """``optim/compression.py::compress_tree`` over a gradient tree of
    ``TRAIN_MODEL``'s every parameter leaf at its published shape
    (normals x 1e-3 from a seeded generator on the card) with a
    non-zero error buffer (one round of feedback), timed with CUDA
    events; then the same call on the CPU copies: codes, scales and the
    new error bitwise on every leaf.  The bound moves each input and
    output once: the f32 gradient and error read, the int8 codes, f32
    scales and f32 error written."""
    import torch

    from repro_torch.optim.compression import BLOCK, compress_tree
    from repro_torch.utils.tree import tree_leaves, tree_map

    model, params = model_params(TRAIN_MODEL)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)

    def draw(p):
        return torch.randn(p.shape, generator=gen, device=DEV) * 1e-3

    grads = tree_map(draw, params)
    del model, params
    _, err = compress_tree(grads, None)
    numel = sum(g.numel() for g in tree_leaves(grads))
    blocks = sum(-(-g.numel() // BLOCK) for g in tree_leaves(grads))
    nbytes = 4 * numel * 3 + blocks * (BLOCK + 4)
    ms = time_ms(lambda: compress_tree(grads, err), reps=3, trials=3)
    q, new_err = compress_tree(grads, err)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_cpu, err_cpu = compress_tree(tree_map(lambda g: g.cpu(), grads),
                                   tree_map(lambda e: e.cpu(), err))
    cpu_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(q) + tree_leaves(new_err),
                     tree_leaves(q_cpu) + tree_leaves(err_cpu)))
    unequal = sum(not torch.equal(a.cpu(), b) for a, b in pairs)
    if unequal:
        raise AssertionError(f"compress_tree: {unequal} of {len(pairs)} "
                             "leaves differ between the card and the CPU")
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"name": "compress_tree", "model": TRAIN_MODEL, "params": numel,
           "leaves": len(tree_leaves(grads)), "ms": ms,
           "gb_per_s": nbytes / ms * 1e-6, "bytes": nbytes,
           "bound_ms": bound_ms, "of_bound": bound_ms / ms,
           "cpu_s": cpu_s, "card_equals_cpu": True, "card": CARD}
    log(f"  compress_tree {TRAIN_MODEL} ({numel} f32 in {out['leaves']} "
        f"leaves): {ms:.3f} ms, {out['gb_per_s']:.1f} GB/s, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB), {out['of_bound']:.4f}"
        f" of it; the CPU {cpu_s:.1f} s, bitwise equal on every leaf")
    del grads, err, q, new_err, q_cpu, err_cpu
    torch.cuda.empty_cache()
    return out


def run_example(name: str, argv: list[str], field: str) -> dict:
    """``examples/<name>.py``'s ``main(argv)`` in this process, its output
    captured and echoed, with the kernels it launched."""
    import contextlib
    import importlib.util
    import io

    import torch

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(argv + ["--device", DEV])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(f"example {name}", ())
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    {name}: {line}")
    if field not in text:
        raise AssertionError(f"example {name}: no {field!r} in its output")
    return {"example": name, "argv": argv, "seconds": dt,
            "lines": text.splitlines()[-6:],
            "launches": {k: v for k, v in launches.items() if v}}


def parent_engine_rows(parent: str) -> list[dict]:
    """``ENGINE_ROWS`` through the parent tree's own ``drive_pool``, in a
    process of its own (its kernels built from its sources)."""
    code = (
        "import json, chip_smoke as c\n"
        "rows = [c.drive_pool(t, n, None, 'fifo', p) for t, n, p in "
        f"{ENGINE_ROWS!r}]\n"
        "print('ROWS ' + json.dumps([{k: r[k] for k in ('task', "
        "'kernels_per_recv', 'ms_per_recv', 'device_busy_ms_per_recv')} "
        "for r in rows]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=parent,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise AssertionError(f"the parent tree's rows failed: "
                             f"{res.stderr[-3000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("ROWS ")]
    return json.loads(line[-1][5:])


def tooling_phase(engine_rows: list[dict], parent: str | None) -> dict:
    """Phase 8: ``compress_tree`` at full width, the five examples at
    their defaults (``PPO_STEPS`` for ppo_atari), and with a ``parent``
    tree the unified engine's kernels a recv (``engine_rows``: phase 3's
    ``ENGINE_ROWS``) beside the parent's, which may be no fewer."""
    out = {"compression": drive_compression()}
    log(f"  ppo_atari_torch: --total-steps cut from 100000 to {PPO_STEPS}")
    out["examples"] = [run_example(*e) for e in EXAMPLES]
    rows = [{k: r[k] for k in ("task", "kernels_per_recv", "ms_per_recv",
                               "device_busy_ms_per_recv")}
            for r in engine_rows]
    out["engine_rows"] = rows
    if parent is not None:
        before = parent_engine_rows(parent)
        out["parent_engine_rows"] = before
        for now, was in zip(rows, before):
            log(f"  {now['task']} sync kernels a recv: parent "
                f"{was['kernels_per_recv']}, this tree "
                f"{now['kernels_per_recv']}")
            if now["kernels_per_recv"] > was["kernels_per_recv"]:
                raise AssertionError(f"{now['task']}: more kernels a recv "
                                     "than the parent tree")
    return out


# ---------------------------------------------------------------------- #
# phase 9: the model-parallel steps on the card
# ---------------------------------------------------------------------- #
# (arch, overrides, batch, seq) of the sharded prefills (phase 3's);
# the sharded serve (phase 3's qwen3 serve) and train step (phase 7's)
MESH_PREFILLS = [("qwen3-0.6b", {}, 4, 8192),
                 ("starcoder2-3b", {"attn_type": "sliding", "window": 4096},
                  1, 8192)]
MESH_SERVE = ("qwen3-0.6b", 8, 1024, 1056, 32)   # batch, prompt, cache, steps
MESH_TRAIN_WARMUP, MESH_TRAIN_TIMED = 1, 3
# ``mesh_memory``'s train step: phase 7's model at train_4k's sequence
MEM_B, MEM_S = 2, 4096
REMATS = ("none", "full", "dots")
# the parameters after a step at ``full`` and ``dots`` against ``none``'s:
# within this share of each leaf's largest magnitude
REMAT_PARAM_TOL = 1e-6
# the MoE, hybrid, Whisper and xLSTM families at full width: phase 3's
# granite prefill cell and a hymba prefill; Whisper's 8 clips with a
# 16-token prompt and an xLSTM prompt of one 256-token chunk, each then
# served 16 greedy steps (batch, prompt, cache, steps)
MESH_FAMILY_PREFILLS = [("granite-moe-3b-a800m", {}, 4, 4096),
                        ("hymba-1.5b", {}, 1, 8192)]
MESH_FAMILY_SERVES = [("whisper-large-v3", 8, 16, 32, 16),
                      ("xlstm-125m", 8, 256, 256, 16)]
# the dry run of this cell on the 16 x 16 fake mesh (launch/dryrun.py)
MESH_DRYRUN = ("qwen3-14b", "train_4k")
# sharded against unsharded in bf16: each difference within this share
# of the largest magnitude of its unsharded leaf
MESH_REL_TOL = 2e-2


def whole(x):
    """A DTensor's full value; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def on_host(cache):
    """A cache's tensors copied to the host: the unsharded row's cache
    kept for ``cache_diffs`` without counting in the sharded row's peak
    memory."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda t: whole(t).cpu(), cache)


def cache_diffs(got, want) -> dict:
    """The largest difference of each cache entry (``k``, ``v``,
    ``ssm_h``, ``xk``, the xLSTM's ``states``, ...; ``len`` apart)
    sharded against unsharded, absolute and over the entry's largest
    magnitude, on the host."""
    from repro_torch.utils.tree import tree_leaves

    out = {}
    for key in want:
        if key == "len":
            continue
        diff = peak = 0.0
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            a, b = whole(a).float().cpu(), b.float().cpu()
            diff = max(diff, float((a - b).abs().max()))
            peak = max(peak, float(b.abs().max()))
        out[key] = {"max_abs_diff": diff, "rel": diff / max(peak, 1e-30)}
    return out


def check_rel(what: str, diffs: dict) -> None:
    bad = {k: v for k, v in diffs.items() if not v["rel"] <= MESH_REL_TOL}
    if bad:
        raise AssertionError(f"{what}: sharded against unsharded beyond "
                             f"{MESH_REL_TOL} of the largest magnitude: "
                             f"{bad}")


def on_mesh(mesh):
    """The sharded steps' scope and shard function: ``BASELINE_RULES`` on
    ``mesh``, plain tensors meeting DTensors as replicated ones."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import BASELINE_RULES, make_shard_fn

    return implicit_replication(), make_shard_fn(mesh, BASELINE_RULES)


def placed(mesh, params, batch) -> tuple:
    """``params`` and ``batch`` laid out on ``mesh`` by their plans."""
    from repro_torch.distributed.sharding import (BASELINE_RULES,
                                                  param_shardings, place)
    from repro_torch.launch.steps import batch_shardings

    return (place(params, param_shardings(mesh, params, BASELINE_RULES),
                  mesh),
            place(batch, batch_shardings(mesh, batch, BASELINE_RULES), mesh))


def timed_calls(fn, calls: int) -> tuple[float, float, dict, object]:
    """``calls`` of ``fn`` with the counts set to 0 just before and read
    just after: (ms a call, peak GB, launches, the last result)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / calls * 1e3
    launches = {k: f.launches for k, f in counters().items()}
    return ms, torch.cuda.max_memory_allocated() / 1e9, launches, out


def mesh_prefill(mesh, arch: str, overrides: dict, batch: int, seq: int
                 ) -> dict:
    """``make_prefill_step`` with and without ``mesh`` on one model and
    one prompt: next tokens identical, the last-position logits' and
    every cache entry's largest difference (each within
    ``MESH_REL_TOL`` of its largest magnitude), flash launches a call
    equal (one a layer), no input copied; ms a call and peak memory of
    each."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import make_prefill_step, synth_batch
    from repro_torch.models import ShapeSpec

    model, params = model_params(arch, attn_impl="blocked", **overrides)
    cfg = model.cfg
    inputs = synth_batch(model, ShapeSpec("prefill", "prefill", seq, batch),
                         torch.Generator(device=DEV).manual_seed(SEED))
    plain = make_prefill_step(model, seq)
    sharded = make_prefill_step(model, seq, mesh)
    copies = flash_attention.copies
    scope, shard = on_mesh(mesh)
    with torch.no_grad():
        want, _ = model.prefill(params, inputs, max_len=seq)
        with scope:
            got, _ = model.prefill(*placed(mesh, params, inputs),
                                   max_len=seq, shard=shard)
        logit_diff = float((got.full_tensor().float() - want.float()).abs()
                           .max())
        logit_rel = logit_diff / float(want.float().abs().max())
        del got, want
        rows = {}
        for name, step in (("plain", plain), ("sharded", sharded)):
            step(params, inputs)                            # warm-up
            ms, peak, launches, (nxt, cache) = timed_calls(
                lambda step=step: step(params, inputs), 2)
            rows[name] = {"ms_per_call": ms, "peak_gb": peak,
                          "launches": launches, "next": nxt,
                          "cache": on_host(cache)}
            del cache
        caches = cache_diffs(rows["sharded"].pop("cache"),
                             rows["plain"].pop("cache"))
    check_rel(f"mesh prefill {arch}", dict(
        caches, logits={"max_abs_diff": logit_diff, "rel": logit_rel}))
    flash = {k: r["launches"]["flash_attention"] / 2 for k, r in rows.items()}
    if flash["sharded"] != cfg.n_layers or flash["plain"] != cfg.n_layers:
        raise AssertionError(f"mesh prefill {arch}: flash launches a call "
                             f"{flash}, want {cfg.n_layers}")
    if not torch.equal(rows["sharded"]["next"], rows["plain"]["next"]):
        raise AssertionError(f"mesh prefill {arch}: next tokens differ")
    if flash_attention.copies != copies:
        raise AssertionError(f"mesh prefill {arch}: flash_attention copied "
                             f"{flash_attention.copies - copies} inputs")
    out = {"model": arch, "attn_type": cfg.attn_type, "batch": batch,
           "seq_len": seq, "layers": cfg.n_layers,
           "ms_per_call": rows["sharded"]["ms_per_call"],
           "plain_ms_per_call": rows["plain"]["ms_per_call"],
           "sharded_over_plain": (rows["sharded"]["ms_per_call"]
                                  / rows["plain"]["ms_per_call"]),
           "peak_gb": rows["sharded"]["peak_gb"],
           "plain_peak_gb": rows["plain"]["peak_gb"],
           "flash_launches_per_call": flash["sharded"],
           "plain_flash_launches_per_call": flash["plain"],
           "flash_copies": flash_attention.copies - copies,
           "next_tokens_equal": True, "max_logit_diff": logit_diff,
           "logit_rel_diff": logit_rel, "cache_diffs": caches,
           "launches": rows["sharded"]["launches"], "card": CARD}
    log(f"  mesh prefill {arch} {cfg.attn_type} B={batch} S={seq} on a "
        f"(1, 1) mesh: {out['ms_per_call']:.1f} ms a call sharded, "
        f"{out['plain_ms_per_call']:.1f} unsharded "
        f"({out['sharded_over_plain']:.3f}x); peak "
        f"{out['peak_gb']:.2f} GB against {out['plain_peak_gb']:.2f}; next "
        f"tokens equal, largest logit difference {logit_diff} "
        f"({logit_rel:.3g} of the largest), cache "
        f"{ {k: v['max_abs_diff'] for k, v in caches.items()} }; flash "
        f"launches a call {flash['sharded']} (unsharded {flash['plain']}), "
        f"copies 0; {CARD}")
    del model, params, rows
    torch.cuda.empty_cache()
    return out


def mesh_serve(mesh, arch: str, batch: int, prompt: int, max_len: int,
               steps: int) -> dict:
    """A prefill of ``batch`` prompts into a ``max_len`` cache, then
    ``steps`` greedy ``make_serve_step`` tokens, with and without
    ``mesh``: every token identical, every cache entry's largest
    difference (each within ``MESH_REL_TOL`` of its largest magnitude:
    the KV rows, Whisper's cross K/V, an xLSTM's states), flash launches
    equal; ms a step and peak memory of each."""
    import torch

    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          synth_batch)
    from repro_torch.models import ShapeSpec

    model, params = model_params(arch, attn_impl="blocked")
    inputs = synth_batch(model, ShapeSpec("serve", "prefill", prompt, batch),
                         torch.Generator(device=DEV).manual_seed(SEED + 1))
    rows = {}
    with torch.no_grad():
        for name, m in (("plain", None), ("sharded", mesh)):
            prefill = make_prefill_step(model, max_len, m)
            serve = make_serve_step(model, m)
            nxt, cache = prefill(params, inputs)
            toks = [nxt]
            nxt, cache = serve(params, cache, {"tokens": nxt[:, None]})
            toks.append(nxt)                               # the warm-up
            state = [nxt, cache]

            def one(serve=serve, state=state):
                state[0], state[1] = serve(params, state[1],
                                           {"tokens": state[0][:, None]})
                return state[0]

            ms, peak, launches, _ = timed_calls(
                lambda: toks.append(one()), steps - 1)
            rows[name] = {"ms_per_step": ms, "peak_gb": peak,
                          "launches": launches,
                          "tokens": torch.stack(toks, 1),
                          "cache": on_host(state[1])}
            del cache, state
    if not torch.equal(rows["sharded"]["tokens"], rows["plain"]["tokens"]):
        raise AssertionError(f"mesh serve {arch}: tokens differ")
    caches = cache_diffs(rows["sharded"].pop("cache"),
                         rows["plain"].pop("cache"))
    check_rel(f"mesh serve {arch}", caches)
    flash = {k: r["launches"].get("flash_attention", 0)
             for k, r in rows.items()}
    if flash["sharded"] != flash["plain"]:
        raise AssertionError(f"mesh serve {arch}: flash launches {flash}")
    out = {"model": arch, "batch": batch, "prompt": prompt,
           "max_len": max_len, "steps": steps,
           "ms_per_step": rows["sharded"]["ms_per_step"],
           "plain_ms_per_step": rows["plain"]["ms_per_step"],
           "sharded_over_plain": (rows["sharded"]["ms_per_step"]
                                  / rows["plain"]["ms_per_step"]),
           "peak_gb": rows["sharded"]["peak_gb"],
           "plain_peak_gb": rows["plain"]["peak_gb"],
           "tokens_equal": True,
           "max_cache_diff": max(v["max_abs_diff"] for v in caches.values()),
           "cache_diffs": caches, "flash_launches": flash["sharded"],
           "plain_flash_launches": flash["plain"],
           "launches": rows["sharded"]["launches"], "card": CARD}
    log(f"  mesh serve {arch} B={batch} prompt {prompt} cache {max_len}, "
        f"{steps} steps on a (1, 1) mesh: {out['ms_per_step']:.2f} ms a step "
        f"sharded, {out['plain_ms_per_step']:.2f} unsharded "
        f"({out['sharded_over_plain']:.3f}x, DTensor's host cost); every "
        f"token equal, largest cache differences "
        f"{ {k: v['max_abs_diff'] for k, v in caches.items()} }; flash "
        f"launches {flash['sharded']} (unsharded {flash['plain']}); peak "
        f"{out['peak_gb']:.2f} GB against {out['plain_peak_gb']:.2f}; "
        f"{CARD}")
    del model, params, rows
    torch.cuda.empty_cache()
    return out


def mesh_train(mesh) -> dict:
    """Phase 7's train step (``TRAIN_MODEL``, blocked, B=``TRAIN_B``
    S=``TRAIN_S``) with and without ``mesh`` from the same state on the
    same batches: ``MESH_TRAIN_WARMUP`` steps, then ``MESH_TRAIN_TIMED``
    timed; every loss within 1e-5 relative, the parameters' largest
    difference, flash launches a step equal (``flash_per_step``); ms a
    step and peak memory of each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import BatchSpec, SyntheticSource
    from repro_torch.distributed.sharding import BASELINE_RULES
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(TRAIN_MODEL, attn_impl="blocked")
    model = build_model(cfg, DEV)
    opt = adamw(weight_decay=0.01)
    state0 = init_train_state(model, opt,
                              torch.Generator(device=DEV).manual_seed(SEED))
    n = MESH_TRAIN_WARMUP + MESH_TRAIN_TIMED
    lr = linear_warmup_cosine(3e-4, 2, n)
    src = SyntheticSource(cfg.vocab, branching=8, seed=1)
    spec = BatchSpec(TRAIN_B, TRAIN_S, cfg.vocab)
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in src.batch(spec, t).items()} for t in range(n)]
    rows = {}
    copies = flash_attention.copies
    for name, m in (("plain", None), ("sharded", mesh)):
        step = make_train_step(model, opt, lr, m, BASELINE_RULES)
        state, losses = state0, []
        for t in range(MESH_TRAIN_WARMUP):
            state, met = step(state, batches[t])
            losses.append(met["loss"])
        it = iter(batches[MESH_TRAIN_WARMUP:])

        def one(step=step):
            nonlocal state
            state, met = step(state, next(it))
            losses.append(met["loss"])

        ms, peak, launches, _ = timed_calls(one, MESH_TRAIN_TIMED)
        rows[name] = {"ms_per_step": ms, "peak_gb": peak,
                      "launches": launches,
                      "losses": [float(x) for x in losses],
                      "params": [whole(x) for x in tree_leaves(state.params)]}
        del state
        torch.cuda.empty_cache()
    lp, ls = (np.asarray(rows[k]["losses"]) for k in ("plain", "sharded"))
    if not (np.isfinite(ls).all() and np.all(np.abs(ls - lp)
                                             <= 1e-5 * np.abs(lp))):
        raise AssertionError(f"mesh train: losses {ls} against {lp}")
    pdiff = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(rows["sharded"]["params"], rows["plain"]["params"]))
    flash = {k: r["launches"]["flash_attention"] / MESH_TRAIN_TIMED
             for k, r in rows.items()}
    want = flash_per_step(cfg)
    if flash["sharded"] != want or flash["plain"] != want \
            or flash_attention.copies != copies:
        raise AssertionError(f"mesh train: flash launches a step {flash}, "
                             f"want {want}; copies "
                             f"{flash_attention.copies - copies}")
    out = {"model": cfg.name, "batch": TRAIN_B, "seq_len": TRAIN_S,
           "timed_steps": MESH_TRAIN_TIMED,
           "ms_per_step": rows["sharded"]["ms_per_step"],
           "plain_ms_per_step": rows["plain"]["ms_per_step"],
           "peak_gb": rows["sharded"]["peak_gb"],
           "plain_peak_gb": rows["plain"]["peak_gb"],
           "losses": rows["sharded"]["losses"],
           "plain_losses": rows["plain"]["losses"],
           "max_loss_rel_diff": float(np.max(np.abs(ls - lp) / np.abs(lp))),
           "max_param_diff": pdiff,
           "flash_launches_per_step": flash["sharded"],
           "flash_copies": flash_attention.copies - copies,
           "launches": rows["sharded"]["launches"], "card": CARD}
    log(f"  mesh train {cfg.name} blocked B={TRAIN_B} S={TRAIN_S} on a "
        f"(1, 1) mesh: {out['ms_per_step']:.2f} ms a step sharded, "
        f"{out['plain_ms_per_step']:.2f} unsharded; losses within "
        f"{out['max_loss_rel_diff']:.3g} relative, largest parameter "
        f"difference {pdiff}; flash launches a step {flash['sharded']} "
        f"(unsharded {flash['plain']}); peak {out['peak_gb']:.2f} GB "
        f"against {out['plain_peak_gb']:.2f}; {CARD}")
    del model, state0, batches, rows
    torch.cuda.empty_cache()
    return out


# the tracker of the dry run against the allocator: within this share of
# the allocator's count, or this many bytes, whichever is larger
MEM_REL_TOL, MEM_ABS_TOL = 0.10, 256 << 20


def mesh_memory(mesh) -> list[dict]:
    """Phase 7's train step (``TRAIN_MODEL`` blocked) at B=``MEM_B``
    S=``MEM_S`` on ``mesh`` at each of ``REMATS``, from the same weights
    on the same batch, on the kernel path on both sides: on meta tensors
    under ``launch/dryrun.py::live_bytes_mode`` (flash_attention's
    stand-in, which allocates what the kernel allocates), and on the
    card (the kernel).  For each: the tracker's peak of the step's own
    bytes against ``torch.cuda.max_memory_allocated()`` less the bytes
    allocated before the step, within ``MEM_REL_TOL`` or
    ``MEM_ABS_TOL``; the flash launches of the step (``flash_per_step``)
    and the ms of a second, timed, step; the parameters after the step
    within ``REMAT_PARAM_TOL`` of each leaf's largest magnitude of
    ``none``'s; and ``full``'s peak below ``none``'s."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_RULES
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (
        init_train_state,
        make_train_step,
        train_state_shapes,
    )
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.utils.tree import tree_leaves

    base = get_config(TRAIN_MODEL, attn_impl="blocked")
    opt = adamw(weight_decay=0.01)
    shape = (MEM_B, MEM_S)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state0 = init_train_state(build_model(base, DEV), opt, gen)
    batch = {k: torch.randint(0, base.vocab, shape, generator=gen,
                              dtype=torch.int32, device=DEV)
             for k in ("tokens", "labels")}
    rows, ref = [], None
    for remat in REMATS:
        cfg = base.replace(remat=remat)
        meta = build_model(cfg, "meta")
        step = make_train_step(meta, opt, constant(3e-4), mesh,
                               BASELINE_RULES)
        state = train_state_shapes(meta, opt)
        mbatch = {k: torch.empty(shape, dtype=torch.int32, device="meta")
                  for k in ("tokens", "labels")}
        live = dryrun.live_bytes_mode()
        t0 = time.perf_counter()
        with live:
            step(state, mbatch)
        meta_s = time.perf_counter() - t0
        tracker, top = live.peak, live.largest_at_peak(3)
        del state, live

        step = make_train_step(build_model(cfg, DEV), opt, constant(3e-4),
                               mesh, BASELINE_RULES)
        copies = flash_attention.copies
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        out = step(state0, batch)
        torch.cuda.synchronize()
        launches = read_counts(f"mesh memory {remat}", ("flash_attention",))
        card = torch.cuda.max_memory_allocated() - before
        loss = float(out[1]["loss"])
        params = [whole(x).cpu() for x in tree_leaves(out[0].params)]
        del out
        t0 = time.perf_counter()
        step(state0, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        if ref is None:
            ref = params
        pdiff = max(float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for a, b in zip(params, ref))
        del params
        diff = abs(tracker - card)
        row = {"model": cfg.name, "remat": remat, "batch": MEM_B,
               "seq_len": MEM_S, "tracker_peak_bytes": tracker,
               "allocator_peak_bytes": card, "diff_bytes": diff,
               "rel_diff": diff / max(card, 1), "meta_s": meta_s,
               "largest_at_tracker_peak": top, "loss": loss,
               "ms_per_step": ms,
               "flash_launches_per_step": launches["flash_attention"],
               "flash_copies": flash_attention.copies - copies,
               "param_diff_of_none": pdiff, "launches": launches,
               "card": CARD}
        log(f"  mesh memory {cfg.name} blocked B={MEM_B} S={MEM_S} remat "
            f"{remat}, train step on a (1, 1) mesh, the kernel path: the "
            f"dry run's tracker on meta {tracker} bytes, the allocator's "
            f"peak on the card {card} bytes ({row['rel_diff']:.4f} apart; "
            f"meta run {meta_s:.1f} s); {ms:.2f} ms a step, "
            f"{row['flash_launches_per_step']} flash launches a step, "
            f"params {pdiff} of each leaf's largest magnitude from none's, "
            f"loss {loss:.6f}; largest at the tracker's peak {top}; {CARD}")
        if not (np.isfinite(loss) and diff <= max(MEM_REL_TOL * card,
                                                  MEM_ABS_TOL)):
            raise AssertionError(f"mesh memory {remat}: tracker {tracker} "
                                 f"bytes against the allocator's {card}")
        if row["flash_launches_per_step"] != flash_per_step(cfg) \
                or row["flash_copies"] or pdiff > REMAT_PARAM_TOL:
            raise AssertionError(f"mesh memory {remat}: {row}")
        rows.append(row)
    del state0, batch, ref
    torch.cuda.empty_cache()
    peaks = {r["remat"]: r["allocator_peak_bytes"] for r in rows}
    if not peaks["full"] < peaks["none"]:
        raise AssertionError(f"mesh memory: full's peak is not below "
                             f"none's: {peaks}")
    return rows


def gloo_dtensor_main(argv: list[str]) -> int:
    """``chip_smoke.py gloo_dtensor <rank> <port>``: one of two processes
    sharing the card over gloo; one DTensor all-gather of a CUDA tensor
    sharded over a mesh of the two; prints one JSON line."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    rank, port = int(argv[0]), argv[1]
    if DEV == "cuda":
        torch.cuda.set_device(0)        # both processes share the card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = init_device_mesh(DEV, (2,))
        full = torch.arange(8, dtype=torch.float32, device=DEV)
        got = distribute_tensor(full, mesh, [Shard(0)],
                                src_data_rank=None).full_tensor()
        ok = bool(torch.equal(got, full)) and got.device.type == DEV
        print(json.dumps({"rank": rank, "equal": ok}))
    finally:
        dist.destroy_process_group()
    return 0


def gloo_dtensor_try() -> dict:
    """Whether two processes sharing the card can all-gather a CUDA
    DTensor over gloo (the port stages nothing through the host for
    it); never fails the run."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "gloo_dtensor", str(i),
         port], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in (0, 1)]
    result = {"ran": True, "error": None}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            lines = stdout.strip().splitlines()
            if p.returncode != 0 or not lines or not json.loads(
                    lines[-1])["equal"]:
                # the exit code and the exception's own line, not the
                # warnings around it
                said = [ln.strip() for ln in (stderr + stdout).splitlines()
                        if "Error" in ln or "error" in ln]
                result = {"ran": False, "error": f"exit {p.returncode}: "
                          + (said[-1] if said else (stderr + stdout)[-600:]
                             .strip())}
    except subprocess.TimeoutExpired:
        result = {"ran": False, "error": "timed out after 120 s"}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"  gloo DTensor all-gather of a CUDA tensor, 2 processes on one "
        f"card: {'ran' if result['ran'] else 'did not run'}"
        + ("" if result["ran"] else f": {result['error']!r}"))
    return result


def dryrun_start(arch: str, shape: str) -> tuple:
    """``python -m repro_torch.launch.dryrun`` on the cell, started in a
    process of its own: one rank of a fake 256-rank group runs the
    sharded step on meta tensors, on the host's CPU alone, so it runs
    beside the card's rows; ``dryrun_row`` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, arch, shape, time.perf_counter()


def dryrun_row(started: tuple) -> dict:
    """The dry run's row: no number in it is a measurement; the H100
    roofline of the production mesh."""
    proc, arch, shape, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"dry run {arch} {shape}: exit "
                             f"{proc.returncode}: {stderr[-2000:]}")
    res = json.loads(stdout[stdout.index("{"):])
    roof, coll = res["roofline"], res["collectives"]
    if res["status"] != "ok" or res["devices"] != 256 \
            or coll["total_count"] <= 0 or not isinstance(
                res["memory_analysis"]["temp_size_in_bytes"], int):
        raise AssertionError(f"dry run {arch} {shape}: {res}")
    out = {"arch": arch, "shape": shape, "mesh": res["mesh"],
           "devices": res["devices"], "wall_s": time.perf_counter() - t0,
           "flops_per_device": res["flops_per_device"],
           "argument_bytes_per_device":
               res["memory_analysis"]["argument_size_in_bytes"],
           "temp_bytes_per_device":
               res["memory_analysis"]["temp_size_in_bytes"],
           "peak_bytes_per_device":
               res["memory_analysis"]["peak_size_in_bytes"],
           "collectives": {k: v for k, v in coll.items()
                           if not isinstance(v, dict) or v["count"]},
           "roofline": roof}
    log(f"  dry run {arch} {shape} on the {res['mesh']} fake mesh (meta "
        f"tensors, no device runs; H100 constants): bound "
        f"{roof['step_time_bound_s']:.4g} s ({roof['dominant']}: compute "
        f"{roof['compute_s']:.4g}, memory {roof['memory_s']:.4g}, "
        f"collective {roof['collective_s']:.4g} s), mfu bound "
        f"{roof['mfu_bound']:.4f}; {coll['total_count']} collectives, "
        f"{coll['total_operand_bytes']} operand bytes a rank; "
        f"{res['flops_per_device']:.4g} FLOPs a rank counted; "
        f"{out['argument_bytes_per_device']} argument bytes a rank, "
        f"{out['temp_bytes_per_device']} temporary and "
        f"{out['peak_bytes_per_device']} at the peak (the step's tensors "
        f"at the config's defaults, counted on meta); done "
        f"{out['wall_s']:.1f} s after its start, beside the card's rows")
    return out


def mesh_phase() -> dict:
    """A process group of one over nccl and a (1, 1) ``DeviceMesh`` of the
    card (``make_debug_mesh``), the model-parallel steps under
    ``BASELINE_RULES`` at full width against the unsharded steps on the
    same weights (the dense decoders, then the MoE, hybrid, Whisper and
    xLSTM families) and, at each ``remat``, the dry run's memory tracker
    against the allocator on the kernel path (``mesh_memory``), the
    group destroyed at the end; then
    the two-process gloo all-gather; the dry run of ``MESH_DRYRUN`` runs
    on the host beside them."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dryrun = dryrun_start(*MESH_DRYRUN)
    try:
        mesh = make_debug_mesh(device=DEV)
        try:
            if tuple(mesh.shape) != (1, 1) or dist.get_backend() != (
                    "nccl" if DEV == "cuda" else "gloo"):
                raise AssertionError(f"mesh {mesh}, {dist.get_backend()}")
            rows = [mesh_prefill(mesh, *MESH_PREFILLS[0]),
                    mesh_serve(mesh, *MESH_SERVE),
                    mesh_prefill(mesh, *MESH_PREFILLS[1]),
                    mesh_train(mesh)]
            rows += [mesh_prefill(mesh, *cell)
                     for cell in MESH_FAMILY_PREFILLS]
            rows += [mesh_serve(mesh, *cell) for cell in MESH_FAMILY_SERVES]
            memory = mesh_memory(mesh)
        finally:
            dist.destroy_process_group()
        gloo = gloo_dtensor_try()
    except BaseException:
        dryrun[0].kill()            # the phase failed: stop the dry run
        dryrun[0].wait()
        raise
    return {"rows": rows, "memory": memory, "gloo_cuda_all_gather": gloo,
            "dryrun": dryrun_row(dryrun)}


def main(argv: list[str]) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--parent", default=None,
                        help="a checkout of the parent commit: phase 8 "
                             "holds the engine's kernels a recv against "
                             "its own")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # fails outside the repository
    from repro_torch.kernels.build import library

    # the resize plain version and the card-vs-CPU f32 checks need true
    # f32 matmuls, and the train runs f32 convs (cuDNN allows TF32 by
    # default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    card = CARD = card_line()
    start = time.perf_counter()

    def at() -> str:
        return f"(at {time.perf_counter() - start:.1f} s)"

    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    library()
    log(f"  kernel library built in {time.perf_counter() - t0:.1f} s")

    log(f"phase 2: kernels against their plain versions {at()}")
    kernels = check_kernels()

    log(f"phase 3: the main paths on the card {at()}")
    ant = ("env_step",)
    pong = ("pong_render", "grayscale", "resize")
    cropped = [repro_torch.Grayscale(), repro_torch.Crop(*PONG_CROP),
               repro_torch.Resize(84, 84), repro_torch.FrameStack(4),
               repro_torch.RewardClip()]
    runs = [
        drive_pool("Ant-v3", 4096, None, "fifo", ant),
        drive_pool("Ant-v3", 4096, None, "fifo", ant, obs=False),
        drive_pool("Ant-v3", 4096, 2048, "fifo", ant),
        drive_pool("PongClassic-v5", 1024, None, "fifo", pong),
        drive_pool("PongClassic-v5", 1024, None, "fifo", pong, obs=False),
        drive_pool("PongClassic-v5", 1024, 512, "sjf", pong),
        drive_pool("PongClassic-v5", 1024, None, "fifo", pong + ("crop",),
                   recvs=50, transforms=cropped),
        drive_pool("Ant-v3", 4096, 2048, "fifo", ant, recvs=50,
                   engine="device-masked"),
        drive_pool("AntSkew-v3", 4096, 2048, "sjf", ant),
        drive_pool("AntNorm-v3", 4096, None, "fifo", ant),
    ]
    log(json.dumps({"pool_runs": runs}))
    train_runs = []
    for task, n, path in (("Ant-v3", 4096, ant),
                          ("PongClassic-v5", 1024, pong)):
        row = drive_train(task, n, 128, path)
        train_runs += [row, drive_train(task, n, 128, path, beside=row)]
    log(json.dumps({"train_runs": train_runs, "card": card}))
    cfg, pol, params = qwen3_params()
    lm_runs = [drive_serve(cfg, pol, params), drive_collect(cfg, params)]
    del pol, params
    log(json.dumps({"lm_runs": lm_runs}))
    model, params = model_params(SERVE_MODEL, attn_impl="blocked")
    model_runs = [drive_prefill(model, params, 4, 8192),
                  drive_model_serve(model, params, 8, 1024, 1056, 32)]
    del model, params
    torch.cuda.empty_cache()
    model, params = model_params("starcoder2-3b", attn_type="sliding",
                                 window=4096, attn_impl="blocked")
    model_runs.append(drive_prefill(model, params, 1, 8192))
    del model, params
    torch.cuda.empty_cache()
    for arch, batch, seq in FAMILY_MODELS:
        model, params = model_params(arch, attn_impl="blocked")
        row = drive_prefill(model, params, batch, seq)
        row.update(branch_ms(model, params, row))
        model_runs += [row, drive_model_serve(model, params, 8, 1024, 1056,
                                              32)]
        del model, params, row
        torch.cuda.empty_cache()
    model_runs += family_phase()
    log(json.dumps({"model_runs": model_runs, "card": card}))
    for r in runs + train_runs + lm_runs + model_runs:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v

    log(f"phase 4: the card against the CPU {at()}")
    cross_check("PongClassic-v5", None)
    cross_check("Ant-v3", 1e-4)
    cross_check("Ant-v3", 1e-4, engine="device-masked")
    cross_check("AntSkew-v3", 1e-4, schedule="sjf")
    cross_check("AntNorm-v3", 1e-3, batch_size=None)
    cross_check_train("PongClassic-v5", 4, None)
    cross_check_train("Ant-v3", 8, 1e-4)
    cross_check_train("PongClassic-v5", 4, None, pipelined=True)
    cross_check_train("Ant-v3", 8, 1e-4, pipelined=True)
    cross_check_serve()
    cross_check_collect()
    cross_check_model("qwen3-0.6b")
    cross_check_model("starcoder2-3b", attn_type="sliding")
    cross_check_lm_train()
    cross_check_lm_train(attn_type="sliding", window=32)
    for arch in ("granite-moe-3b-a800m", "hymba-1.5b", "xlstm-125m",
                 "whisper-large-v3", "qwen2-vl-72b"):
        cross_check_model(arch)
    cross_check_lm_train("granite-moe-3b-a800m")
    cross_check_lm_train("hymba-1.5b")

    log(f"phase 5: the host engines {at()}")
    host_runs = host_phase()
    log(json.dumps({"host_runs": host_runs, "card": card}))
    for r in host_runs:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v

    log(f"phase 6: the sharded engine on the card {at()}")
    sharded = sharded_phase()
    log(json.dumps({"sharded_runs": sharded, "card": card}))
    for r in sharded["pools"] + [sharded["ranks"], sharded["train"]]:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v

    log(f"phase 7: the LM trainer on the card {at()}")
    lm_train = {"step": drive_lm_train(), "cli": drive_lm_cli()}
    log(json.dumps({"lm_train": lm_train, "card": card}))
    for k, v in lm_train["step"]["launches"].items():
        kernels[k]["launches"] += v

    log(f"phase 8: the tooling and the examples {at()}")
    tooling = tooling_phase([runs[0], runs[3]], args.parent)
    log(json.dumps({"tooling": tooling, "card": card}))
    for r in tooling["examples"]:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v

    log(f"phase 9: the model-parallel steps on the card {at()}")
    mesh = mesh_phase()
    log(json.dumps({"mesh_runs": mesh, "card": card}))
    for r in mesh["rows"] + mesh["memory"]:
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v

    log(f"done {at()}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


TURN_PATHS = {"Ant-v3": (4096, ("env_step",)),
              "PongClassic-v5": (1024, ("pong_render", "grayscale",
                                        "resize"))}


def train_turns(argv: list[str]) -> int:
    """``python3 chip_smoke.py turns [--tasks Ant-v3,PongClassic-v5]
    [--rounds 1]``: ``drive_train`` through ``train_device``,
    ``train_pipelined`` and ``train_pipelined`` with both halves on one
    stream (its ``_Streams`` made the CPU's no-ops: the pipelined order
    and code without the second stream) in turns, device, two streams,
    one stream, one stream, two streams, device for each task and round,
    so each driver's spread shows beside their differences on one card;
    one JSON line a run (the row without its history and launches, with
    its ``variant``), the card's name and power limit first."""
    import argparse

    import torch

    from repro_torch.rl import ppo

    parser = argparse.ArgumentParser(prog="chip_smoke.py turns")
    parser.add_argument("--tasks", default="Ant-v3,PongClassic-v5")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.build import library

    class OneStream(ppo._Streams):
        def __init__(self, dev):
            super().__init__(torch.device("cpu"))

    global CARD
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = card_line()
    log(CARD)
    library()
    two_streams = ppo._Streams
    for r in range(args.rounds):
        for task in args.tasks.split(","):
            n, path = TURN_PATHS[task]
            device_row = None
            for variant in ("device", "two streams", "one stream",
                            "one stream", "two streams", "device"):
                ppo._Streams = (OneStream if variant == "one stream"
                                else two_streams)
                try:
                    row = drive_train(task, n, 128, path,
                                      beside=None if variant == "device"
                                      else device_row)
                finally:
                    ppo._Streams = two_streams
                if variant == "device":
                    device_row = row
                log(json.dumps({"round": r, "variant": variant, **{
                    k: v for k, v in row.items()
                    if k not in ("history", "launches",
                                 "top_kernels_ms_per_iter")},
                    "card": CARD}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["turns"]:
        sys.exit(train_turns(sys.argv[2:]))
    if sys.argv[1:2] == ["gloo_dtensor"]:
        sys.exit(gloo_dtensor_main(sys.argv[2:]))
    if sys.argv[1:2] == ["cnn_witness"]:
        sys.exit(cnn_witness(sys.argv[2:]))
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["rank"]
             else main(sys.argv[1:]))
