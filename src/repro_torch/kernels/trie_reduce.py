"""Full-ruleset traversal reduction (the paper's visit-every-rule pass).

``trie_reduce_columns`` returns ``(n_rules, Σ support, max confidence,
Σ confidence)`` as f32 scalars over the nodes at ``depth > 0``; the max is
0 when no node is live, and an empty trie reduces to zeros.

On a CUDA tensor it launches the Triton kernel below (replacing the TPU
kernel ``repro.kernels.trie_reduce.trie_reduce_pallas``); on a CPU tensor
it runs the plain version ``ref.trie_reduce_ref``.  Triton fits here: the
work is one masked column reduction, which ``tl.sum``/``tl.max`` over a
block express, with no data-dependent control flow and no shared-memory
layout to design.

Quantized columns (the compressed layout: int32 support counts, bf16 or
int8 confidence) are loaded in their storage types and widened in
registers with ``dequantize_metrics``'s arithmetic (count times the f32
reciprocal of ``n_transactions``; int8 code times its scale).

What bounds it: memory.  It reads at most 12 bytes per node (support,
confidence, depth) once and does three adds and a max per node.  Two
passes -- one partial per program, then one program folds the partials --
instead of atomics, so the sums repeat bitwise from run to run.  Count and max are
exact in any order (the f32 count is exact below 2^24 nodes); the sums
reassociate and hold to the plain version within 1e-6 relative.
"""
from __future__ import annotations

import torch

from .metrics_inkernel import count_reciprocal, storage_codes
from .ref import trie_reduce_ref
from .tuning import DEFAULTS

_FOLD_BLOCK = 1024
_kernels = {}


def _triton_kernels():
    """Define the two Triton kernels on first use (``triton`` exists only
    where a CUDA build of PyTorch is installed)."""
    if _kernels:
        return _kernels["partials"], _kernels["fold"]
    import triton
    import triton.language as tl

    @triton.jit
    def partials(sup_ptr, conf_ptr, depth_ptr, part_ptr, n, inv_n,
                 conf_scale, SUP_COUNTS: tl.constexpr,
                 CONF_INT8: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        live = tl.load(depth_ptr + offs, mask=offs < n, other=0) > 0
        sup = tl.load(sup_ptr + offs, mask=live, other=0).to(tl.float32)
        if SUP_COUNTS:
            sup = sup * inv_n
        conf = tl.load(conf_ptr + offs, mask=live, other=0).to(tl.float32)
        if CONF_INT8:
            conf = conf * conf_scale
        base = part_ptr + pid * 4
        tl.store(base, tl.sum(live.to(tl.float32), axis=0))
        tl.store(base + 1, tl.sum(tl.where(live, sup, 0.0), axis=0))
        tl.store(base + 2,
                 tl.max(tl.where(live, conf, float("-inf")), axis=0))
        tl.store(base + 3, tl.sum(tl.where(live, conf, 0.0), axis=0))

    @triton.jit
    def fold(part_ptr, out_ptr, p, BLOCK: tl.constexpr):
        cnt = tl.zeros([BLOCK], dtype=tl.float32)
        ssum = tl.zeros([BLOCK], dtype=tl.float32)
        cmax = tl.full([BLOCK], float("-inf"), dtype=tl.float32)
        csum = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, p, BLOCK):
            idx = start + tl.arange(0, BLOCK)
            m = idx < p
            cnt += tl.load(part_ptr + idx * 4, mask=m, other=0.0)
            ssum += tl.load(part_ptr + idx * 4 + 1, mask=m, other=0.0)
            cmax = tl.maximum(
                cmax,
                tl.load(part_ptr + idx * 4 + 2, mask=m, other=float("-inf")),
            )
            csum += tl.load(part_ptr + idx * 4 + 3, mask=m, other=0.0)
        total = tl.sum(cnt, axis=0)
        tl.store(out_ptr, total)
        tl.store(out_ptr + 1, tl.sum(ssum, axis=0))
        mx = tl.max(cmax, axis=0)
        tl.store(out_ptr + 2, tl.where(total > 0, mx, 0.0))
        tl.store(out_ptr + 3, tl.sum(csum, axis=0))

    _kernels.update(partials=partials, fold=fold)
    return partials, fold


def trie_reduce_columns(support, confidence, depth, n_transactions: int = 0,
                        confidence_scale: float = 1.0):
    """``(n_rules, Σ support, max confidence, Σ confidence)``, f32
    scalars; ``support`` f32, int32 counts or bf16, ``confidence`` f32,
    bf16 or int8."""
    dev = support.device
    if dev.type == "cpu":
        return trie_reduce_ref(support, confidence, depth, n_transactions,
                               confidence_scale)
    if dev.type != "cuda":
        raise ValueError(f"trie_reduce_columns: unsupported device {dev}")
    n = support.shape[0]
    if n == 0:
        z = torch.zeros((4,), dtype=torch.float32, device=dev)
        return z[0], z[1], z[2], z[3]
    from . import _build

    storage_codes("trie_reduce_columns", support, confidence, confidence)
    _build.check_inputs(
        "trie_reduce_columns", dev,
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        depth=(depth, torch.int32, 1),
    )
    partials, fold = _triton_kernels()
    block = DEFAULTS.reduce_block
    n_prog = -(-n // block)
    part = torch.empty((n_prog, 4), dtype=torch.float32, device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        partials[(n_prog,)](
            support, confidence, depth, part, n,
            count_reciprocal(n_transactions), float(confidence_scale),
            SUP_COUNTS=support.dtype == torch.int32,
            CONF_INT8=confidence.dtype == torch.int8,
            BLOCK=block, num_warps=8)
        fold[(1,)](part, out, n_prog, BLOCK=_FOLD_BLOCK, num_warps=4)
    trie_reduce_columns.launches += 1
    return out[0], out[1], out[2], out[3]


trie_reduce_columns.launches = 0
