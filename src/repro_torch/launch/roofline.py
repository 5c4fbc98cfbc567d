"""The card's peaks and a kernel's roofline (``kernel_roofline``).

Hardware constants: one NVIDIA H100 SXM 80GB at its 700 W power limit
(NVIDIA's data sheet, dense rates without sparsity): 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s all to all, 450 GB/s each way (``LINK_BW``: a
collective's bytes leave a card in one direction).  A card set below
700 W runs slower under load: ``nvidia-smi`` reports its limit.

The reference's model half (``model_flops``, ``analyze_record`` and the
table over dry-run records) comes with the port's dry run, which makes
those records.
"""
from __future__ import annotations

from typing import Dict

CARD = "NVIDIA H100 SXM 80GB at 700 W (data sheet, dense)"
PEAK_FLOPS = 989e12   # bf16 on the tensor cores
FP32_FLOPS = 67e12    # float32 on the CUDA cores
HBM_BW = 3.35e12      # HBM3, bytes/s
LINK_BW = 450e9       # NVLink 4, bytes/s each way

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
