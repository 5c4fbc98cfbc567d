"""Roofline analysis: the card's peaks, a kernel's roofline
(``kernel_roofline``) and the model half over the dry run's records.

Per (arch x shape x mesh) cell, from the records ``launch/dryrun.py``
writes (one device's program, so the numbers are already per device):

    compute term    = flops_per_device / PEAK_FLOPS
    memory term     = bytes_per_device / HBM_BW
    collective term = collective_bytes_per_device / LINK_BW

The dominant term is the bottleneck; the model-FLOPs ratio (6·N·D for
dense, 6·N_active·D for MoE) measures how much counted compute is
"useful".

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir D] [--mesh M]

Hardware constants: one NVIDIA H100 SXM 80GB at its 700 W power limit
(NVIDIA's data sheet, dense rates without sparsity): 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s all to all, 450 GB/s each way (``LINK_BW``: a
collective's bytes leave a card in one direction).  A card set below
700 W runs slower under load: ``nvidia-smi`` reports its limit.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

CARD = "NVIDIA H100 SXM 80GB at 700 W (data sheet, dense)"
PEAK_FLOPS = 989e12   # bf16 on the tensor cores
FP32_FLOPS = 67e12    # float32 on the CUDA cores
HBM_BW = 3.35e12      # HBM3, bytes/s
LINK_BW = 450e9       # NVLink 4, bytes/s each way

# the dry run's records (``launch/dryrun.py``'s ``OUT_DIR``)
DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "dryrun_out")

# Per-backend peaks for a kernel's achieved-vs-peak bandwidth
# (``kernel_roofline``).  The gpu row is the card above; the cpu row is a
# deliberately conservative dual-channel DDR4 envelope (~25.6 GB/s), so a
# figure from the plain versions on a host reads as what it is.
KERNEL_PEAKS = {
    "gpu": {"peak_flops": PEAK_FLOPS, "hbm_gbps": HBM_BW / 1e9,
            "card": CARD},
    "cpu": {"peak_flops": 1e12, "hbm_gbps": 25.6,
            "card": "a dual-channel DDR4 host (an envelope, not a card)"},
}


def _backend_of(where=None) -> str:
    """The backend name of a device (``torch.device`` or a name such as
    ``"cuda:0"``: CUDA is ``"gpu"``) or of a backend name, which passes
    through; None is this host's: ``"gpu"`` where CUDA is available."""
    if where is None:
        import torch

        return "gpu" if torch.cuda.is_available() else "cpu"
    kind = getattr(where, "type", None) or str(where).split(":")[0]
    return "gpu" if kind == "cuda" else kind


def kernel_roofline(bytes_moved: float, seconds: float, backend=None) -> Dict:
    """Achieved-vs-peak bandwidth of one kernel call.

    ``bytes_moved`` is the call's working set (the trie kernels are
    memory-bound column sweeps, so bytes over the peak rate is their
    roof); ``seconds`` the measured time per call; ``backend`` a device or
    a backend name (``_backend_of``).  Returns the achieved GB/s, the
    backend's peak and their ratio.  An unknown backend falls back to the
    cpu envelope."""
    backend = _backend_of(backend)
    peaks = KERNEL_PEAKS.get(backend, KERNEL_PEAKS["cpu"])
    achieved = (bytes_moved / seconds) / 1e9 if seconds > 0 else 0.0
    peak = peaks["hbm_gbps"]
    return {
        "backend": backend,
        "bytes_moved": float(bytes_moved),
        "seconds": float(seconds),
        "achieved_gbps": achieved,
        "peak_gbps": peak,
        "bandwidth_util": achieved / peak if peak > 0 else 0.0,
    }


def model_flops(arch: str, shape_name: str) -> float:
    """6·N_active·D (training) / 2·N_active·D (single forward)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.models import count_params_analytic

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n_active = count_params_analytic(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def analyze_record(rec: Dict, use_boundary: bool = False) -> Dict:
    """The record with its three terms over the card's peaks, the
    dominant one, and the useful-FLOPs ratio and roofline fraction.
    ``use_boundary=True`` takes the fusion-boundary memory estimate where
    recorded; the table uses the unfused upper bound throughout."""
    flops = rec["flops_per_device"]
    mem_bytes = rec["bytes_per_device"]
    if use_boundary:
        mem_bytes = rec.get("bytes_boundary_per_device", mem_bytes)
    coll = rec["collective_bytes_per_device"]["total"]
    chips = rec["n_devices"]
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": mem_bytes / HBM_BW,
        "memory_unfused_s": rec["bytes_per_device"] / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    core = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    dominant = max(core, key=core.get)
    mf = model_flops(rec["arch"], rec["shape"])
    counted_global = flops * chips
    bound = max(core.values())
    useful_s = (mf / chips) / PEAK_FLOPS
    out = dict(rec)
    out.update({
        "terms": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": counted_global,
        "useful_ratio": mf / counted_global if counted_global else 0.0,
        # the share of the compute roof the dominant bound leaves:
        # useful model time over the bound's time
        "roofline_fraction": useful_s / bound if bound else 0.0,
    })
    return out


def load_records(dryrun_dir: str = DRYRUN_DIR) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def what_moves_it(rec: Dict) -> str:
    d = rec["dominant"]
    if d == "compute_s":
        if rec["useful_ratio"] < 0.4:
            return (
                "compute-bound with low useful ratio: cut non-model flops "
                "(causal chunk skipping, less remat recompute)"
            )
        return "compute-bound: larger per-chip batch or more chips"
    if d == "memory_s":
        return (
            "HBM-bound: fuse/shrink intermediates (bf16 scores, fewer "
            "materialized masks), increase arithmetic intensity"
        )
    return (
        "collective-bound: shrink collective payloads (bf16 psum, "
        "reduce-scatter instead of all-reduce) or overlap with compute"
    )


def table(records: List[Dict], mesh: Optional[str] = "pod16x16") -> str:
    rows = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | useful | roofline frac |",
        "|" + "---|" * 9,
    ]
    for rec in records:
        if mesh and rec["mesh"] != mesh:
            continue
        a = analyze_record(rec)
        t = a["terms"]
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {t['compute_s']:.3e} | {t['memory_s']:.3e} "
            f"| {t['collective_s']:.3e} | {a['dominant'][:-2]} "
            f"| {a['useful_ratio']:.2f} | {a['roofline_fraction']:.3f} |"
        )
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=DRYRUN_DIR)
    p.add_argument("--mesh", default=None,
                   help="pod16x16 | pod2x16x16 | None=all")
    args = p.parse_args(argv)
    records = load_records(args.dir)
    print(f"peaks: {CARD}")
    print(table(records, args.mesh))
    print()
    for rec in records:
        if args.mesh and rec["mesh"] != args.mesh:
            continue
        a = analyze_record(rec)
        print(f"{a['arch']} × {a['shape']} × {a['mesh']}: "
              f"{a['dominant'][:-2]}-bound — {what_moves_it(a)}")


if __name__ == "__main__":
    main()
