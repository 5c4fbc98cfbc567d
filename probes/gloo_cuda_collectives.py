#!/usr/bin/env python3
"""Which collectives the gloo backend takes on CUDA tensors, with four
ranks on one card (NCCL refuses two ranks on one GPU).

    python3 probes/gloo_cuda_collectives.py [--ranks 4]

For each collective the port's multi-rank paths call, a fresh world of
``--ranks`` processes (meeting over a FileStore in a temporary
directory) puts its tensors on ``cuda:0`` and calls it once: the c10d
calls the paths make directly (``all_reduce``: the MoE's psum,
``compressed_psum``, the loss; ``all_gather``: the serving MoE's token
gather), the ones DTensor's redistribution makes through the functional
collectives (``funcol_all_gather``: a ``Shard`` to ``Replicate()``;
``funcol_reduce_scatter``: a partial gradient back to its shard;
``funcol_all_reduce``: a ``Partial`` to ``Replicate()``), and the c10d
forms of those (``all_gather_into_tensor``, ``reduce_scatter_tensor``)
and ``all_to_all_single``.  One line each: ``ok``, ``wrong values``, the
error it raised, or the exit code of a rank that died (a segfault is
-11).  Exits non-zero when CUDA is unavailable.
"""
import argparse
import json
import multiprocessing
import os
import sys
import tempfile

import torch
import torch.distributed as dist


def _check(name, rank, n, dev):
    """Run collective ``name`` once; whether its values are right."""
    import torch.distributed._functional_collectives as funcol

    x = torch.full((n * 2,), float(rank + 1), device=dev)
    want_sum = float(sum(range(1, n + 1)))
    ranks = torch.arange(1, n + 1, device=dev).float()
    group = dist.group.WORLD
    if name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == want_sum).all())
    if name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return all(bool((p == r + 1).all()) for r, p in enumerate(parts))
    if name == "all_gather_into_tensor":
        out = torch.empty(n * x.numel(), device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool(torch.equal(out, ranks.repeat_interleave(x.numel())))
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == want_sum).all())
    if name == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return bool(torch.equal(out, ranks.repeat_interleave(2)))
    if name == "funcol_all_gather":
        out = funcol.all_gather_tensor(x, 0, group).wait()
        return bool(torch.equal(out, ranks.repeat_interleave(x.numel())))
    if name == "funcol_reduce_scatter":
        out = funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()
        return bool((out == want_sum).all())
    if name == "funcol_all_reduce":
        out = funcol.all_reduce(x, "sum", group).wait()
        return bool((out == want_sum).all())
    raise ValueError(name)


CHECKS = ("all_reduce", "all_gather", "all_gather_into_tensor",
          "reduce_scatter_tensor", "all_to_all_single", "funcol_all_gather",
          "funcol_reduce_scatter", "funcol_all_reduce")


def _rank(name, rank, n, store_path, out_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    dev = torch.device("cuda", 0)
    try:
        ok = _check(name, rank, n, dev)
        torch.cuda.synchronize()
        res = "ok" if ok else "wrong values"
    except Exception as exc:   # the probe's answer: which one fails
        res = f"{type(exc).__name__}: {exc}"[:300]
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _world(name, n, timeout=120):
    """One world running ``name``: its answer, or how its ranks died."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [ctx.Process(target=_rank, args=(
            name, r, n, os.path.join(tmp, "store"), out)) for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = sorted({p.exitcode for p in procs})
        if codes != [0] or not os.path.exists(out):
            return f"ranks exited with {codes}"
        with open(out) as f:
            return json.load(f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_collectives: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}; {args.ranks} gloo ranks on "
          "cuda:0, a fresh world a collective")
    for name in CHECKS:
        print(f"{name}: {_world(name, args.ranks)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
