"""End-to-end training driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch smollm-360m --reduced --steps 200 --resume auto

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m --reduced --steps 200

PyTorch port of ``repro.launch.train``, with its flags and printed lines,
plus ``--device`` (CUDA unless named; ``cpu`` runs the same path on the
host) and ``--seed`` (the generator the weights are drawn from).  Under
``torchrun`` (``WORLD_SIZE`` above 1) each process joins the world
(NCCL on CUDA, rank r on ``cuda:r``; gloo on the CPU) and trains on the
1 x n ``("data", "model")`` host mesh: params and optimizer state placed
by ``train.elastic.remesh_state`` with the logical rules, each rank
computing on its rows of the global batch (``("batch", "seq")``), rank 0
printing and writing checkpoints of whole tensors in the one-device
layout (so they restore across meshes and packages; a restore is placed
again by ``remesh_state``).  What it exercises:
  - the deterministic, stateless-seekable data pipeline (a restart sees
    the same stream);
  - async, atomic, hash-verified checkpoints and auto-resume;
  - straggler detection (EWMA step times);
  - microbatch gradient accumulation;
  - optional int8 error-feedback gradient compression.
``main(argv)`` returns what the run produced (losses, step ms, the final
params and optimizer state, the compressor's residual) for callers that
drive it in process.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.array_trie import resolve_device
from repro_torch.data.pipeline import (
    PipelineConfig,
    TokenPipeline,
    synthetic_corpus,
)
from repro_torch.distributed.compression import ErrorFeedbackInt8
from repro_torch.distributed.sharding import is_placed, use_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import materialize_params
from repro_torch.pytree import tree_map
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.train.elastic import StragglerDetector, remesh_state
from repro_torch.train.optimizer import OptConfig, pick_optimizer
from repro_torch.train.train_step import make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", default="auto", choices=["auto", "never"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _join_world(device):
    """Under ``torchrun`` (``WORLD_SIZE`` above 1, no group up yet): join
    the world and return (this rank's device, whether this call started
    the group); else (``device`` resolved, False)."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return resolve_device(device), False
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, True


def _whole(tree):
    """Every placed leaf gathered whole (a collective: every rank calls
    it), for a checkpoint in the one-device layout."""
    return tree_map(lambda x: x.full_tensor() if is_placed(x) else x, tree)


def main(argv=None):
    import torch.distributed as dist

    args = parse_args(argv)
    dev, started = _join_world(args.device)
    try:
        return _train(args, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, dev):
    cfg = (
        get_reduced_config(args.arch) if args.reduced
        else get_config(args.arch)
    )
    # fit the byte vocab when training on the synthetic corpus
    cfg = cfg.scaled(vocab_size=max(cfg.vocab_size, 260))

    mesh = make_host_mesh(dev)
    placed = hasattr(mesh, "device_mesh")
    lead = not placed or mesh.device_mesh.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    docs = synthetic_corpus(512, seed=1)
    pipe = TokenPipeline(
        docs, PipelineConfig(seq_len=args.seq, global_batch=args.batch)
    )
    log(f"pipeline: {pipe.n_rows} packed rows")

    with use_mesh(mesh):
        params, axes = materialize_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        opt = pick_optimizer(cfg, OptConfig(lr=args.lr, warmup_steps=20))
        opt_state = opt.init(params)

        def place(params, opt_state):
            if not placed:
                return params, opt_state
            return (remesh_state(params, axes, mesh),
                    remesh_state(opt_state, opt.state_axes(axes), mesh))

        params, opt_state = place(params, opt_state)

        compressor = ErrorFeedbackInt8() if args.compress_grads else None
        state = {"residual": compressor.init(params) if compressor else None}

        grad_transform = None
        if compressor is not None:
            # stateful hook: the closure carries the residual across steps
            def grad_transform(grads):
                dq, state["residual"] = compressor.compress(
                    grads, state["residual"]
                )
                return dq

        step_fn = make_train_step(
            cfg, opt, microbatches=args.microbatches,
            grad_transform=grad_transform,
        )

        start_step = 0
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if args.resume == "auto":
            restored, manifest = restore_latest(
                args.ckpt_dir, {"params": params, "opt": opt_state}
            )
            if restored is not None:
                params, opt_state = place(restored["params"],
                                          restored["opt"])
                start_step = manifest["step"] + 1
                log(f"resumed from step {manifest['step']}")

        detector = StragglerDetector()
        losses, step_ms = [], []
        timer = dev.type == "cuda"
        for step in range(start_step, args.steps):
            batch = {
                k: torch.as_tensor(v, device=dev)
                for k, v in pipe.batch_at(step).items()
            }
            t0 = time.time()
            if timer:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
            params, opt_state, metrics = step_fn(
                params, opt_state, batch, float(step)
            )
            if timer:
                ev[1].record()
            loss = float(metrics["loss"])
            dt = time.time() - t0
            step_ms.append(ev[0].elapsed_time(ev[1]) if timer else dt * 1e3)
            losses.append(loss)
            if detector.observe(step, dt):
                log(f"[straggler] sustained slowdown at step {step} "
                    f"({dt:.2f}s vs ewma {detector._ewma:.2f}s) — a real "
                    "deployment re-meshes here (train/elastic.py)")
            if step % args.log_every == 0:
                log(f"step {step:5d} loss {loss:.4f} "
                    f"({dt*1000:.0f} ms)", flush=True)
            if step and step % args.ckpt_every == 0:
                tree = _whole({"params": params, "opt": opt_state})
                if lead:
                    ckpt.save_async(step, tree, extra={"loss": loss})
        ckpt.wait()
        tree = _whole({"params": params, "opt": opt_state})
        if lead:
            ckpt.save_async(args.steps - 1, tree)
        ckpt.wait()
        if placed:   # no rank reads the directory before rank 0 wrote it
            torch.distributed.barrier()
        first = np.mean(losses[:10])
        last = np.mean(losses[-10:])
        log(f"done: loss {first:.3f} → {last:.3f} "
            f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"cfg": cfg, "mesh": mesh, "losses": losses, "step_ms": step_ms,
            "start_step": start_step, "params": params,
            "opt_state": opt_state, "optimizer": opt,
            "residual": state["residual"]}


if __name__ == "__main__":
    main()
