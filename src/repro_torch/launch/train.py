"""The LM trainer (``repro/launch/train.py``): any ``--arch`` on one
device or on the ``--mesh debug`` mesh, with checkpoints and restart.

Checkpoints are atomic and written on a thread (``CheckpointStore``);
SIGTERM flushes one at the next step boundary and exits 0; a run
started again with the same ``--ckpt-dir`` resumes from the newest
step, and the data pipeline gives it the same batches it would have
had (a batch is a function of the step).  One JSON line every
``--log-every`` steps; ``--out-json`` writes them all at the end.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 200 --batch 8 --seq 256 --ckpt-dir ck \\
        --ckpt-every 50 [--device cpu]

It runs on the card unless ``--device`` names another device.

``--mesh debug`` trains the model-parallel step on
``launch/mesh.py::make_debug_mesh`` under ``BASELINE_RULES``: the state
laid out by ``train_state_shardings``, each batch by
``batch_shardings``.  Every rank builds the same state from the same
seed and keeps its shards; rank 0 writes full checkpoints and a restart
restores each rank's shards.  A SIGTERM to any rank stops them all at
the same step (one all-reduce of a flag a step).  Over several
processes start it with torchrun, which sets the job's environment:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3-0.6b --smoke --mesh debug --device cpu ...

(over nccl on the card, one card a process; over gloo on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none", choices=["none", "debug"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)

    import torch

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import BatchSpec, SyntheticSource
    from repro_torch.distributed.sharding import BASELINE_RULES, place
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (
        init_train_state,
        make_train_step,
        train_state_shardings,
    )
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.optim import adamw, linear_warmup_cosine

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.ssm is not None and args.seq % cfg.ssm.chunk:
        cfg = cfg.replace(ssm=dataclasses.replace(
            cfg.ssm, chunk=min(cfg.ssm.chunk, args.seq)))

    model = build_model(cfg, device)
    opt = adamw(weight_decay=0.01)
    state = init_train_state(model, opt,
                             torch.Generator(device=device).manual_seed(0))
    n_params = count_params(state.params)
    print(f"arch={cfg.name} params={n_params:,} (~{n_params / 1e6:.1f}M) "
          f"device={device}", flush=True)
    lr_fn = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    mesh = plan = None
    rules = BASELINE_RULES
    if args.mesh == "debug":
        mesh = make_debug_mesh(device=device)
        plan = train_state_shardings(mesh, state, rules)
        state = place(state, plan, mesh)
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"rank={torch.distributed.get_rank()}", flush=True)
    train_step = make_train_step(model, opt, lr_fn, mesh, rules,
                                 microbatches=args.microbatches)

    store = None
    start_step = 0
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir)
        store.install_preemption_handler()
        last = store.latest_step()
        if last is not None:
            state = store.restore(last, state, plan, mesh)
            start_step = int(state.step)
            print(f"restored checkpoint step {start_step}", flush=True)

    source = SyntheticSource(cfg.vocab, branching=8, seed=1)
    bspec = BatchSpec(args.batch, args.seq, cfg.vocab)
    history = []
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in source.batch(bspec, step).items()}
        state, metrics = train_step(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            tps = tokens_per_step * (step - start_step + 1) / max(dt, 1e-9)
            rec = {"step": step, "loss": round(loss, 4),
                   "lr": float(metrics["lr"]),
                   "tokens_per_s": round(tps, 1), "time_s": round(dt, 1)}
            history.append(rec)
            print(json.dumps(rec), flush=True)
        stop = store is not None and _any_rank(store.preempted.is_set(),
                                                mesh, device)
        if store and ((step + 1) % args.ckpt_every == 0 or stop):
            store.save_async(step + 1, state, {"arch": cfg.name})
            if stop:
                store.wait()
                print("preempted: checkpoint flushed, exiting", flush=True)
                return
    if store:
        store.save(args.steps, state, {"arch": cfg.name})
    if history:
        print(f"done: entropy_floor={source.entropy_floor:.3f} "
              f"final_loss={history[-1]['loss']:.3f}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(history, f)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def _any_rank(flag: bool, mesh, device) -> bool:
    """``flag`` of any rank of the mesh's job (this rank's alone without
    a mesh)."""
    if mesh is None:
        return flag
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


if __name__ == "__main__":
    main()
