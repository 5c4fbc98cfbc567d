"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared
libraries, bound with ``ctypes``.

Every ``csrc/*.cu`` becomes its own library, all compiled in parallel at
first use, into ``build/repro_torch_kernels/<hash>/`` at the checkout root;
the hash covers every source, header and flag, so an edited source
rebuilds and an unchanged one loads.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# -fmad=false and the default IEEE divide keep the score math bitwise equal
# to the plain PyTorch versions; -Xptxas -v reports registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# quantized metric columns: three pointers, the support and confidence/lift
# storage codes, then 1 / n_transactions and the two int8 scales
_COLUMNS = (_P, _P, _P, _I, _I, _F, _F, _F)

# C entry points: library -> {function: argtypes}; each returns the first
# non-zero cudaError_t of its launches (0 on success).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "rank": {
        "topk_rank_batch_launch": (
            *_COLUMNS, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P,
        ),
    },
    "item_index": {
        "rules_with_launch": (
            *_COLUMNS, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
            _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
            _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ),
    },
    "rule_search": {
        "rule_search_fused_launch": (
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _P,
        ),
        "rule_search_span_launch": (
            _P, _P, _P, _P, _P, _P, *_COLUMNS, _P, _P, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _P,
        ),
        "rule_search_sweep_launch": (
            _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P,
            _P, _P, _P, _P, _P, _P,
        ),
    },
    "trie_reduce": {
        "trie_reduce_launch": (*_COLUMNS, _P, _I, _I, _I, _I, _P, _P, _P),
    },
    "support_count": {
        "support_prepass_launch": (_P, _I, _I, _I, _P, _P, _P),
        "support_count_launch": (
            _P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P,
            _P,
        ),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels cannot be "
        "built on this host"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; idempotent."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in SIGNATURES:
            so = out_dir / f"lib{name}.so"
            if so.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            procs[name] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp, so,
            )
        logs = {}
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed)
            )
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn, argtypes in fns.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        build_info.update(dir=str(out_dir), ptxas=logs)
        return _libs


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")


def check_inputs(what: str, device, **tensors) -> None:
    """Every named ``(tensor, dtype, ndim)`` must lie on ``device``, be
    contiguous and have that dtype and rank: the C entry points take raw
    pointers and trust them, and launch on the current CUDA device."""
    import torch

    if device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"{what}: tensors are on {device} but the current CUDA device "
            f"is {torch.cuda.current_device()}; launch under "
            f"torch.cuda.device({device})"
        )
    for name, (t, dtype, ndim) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.dim() != ndim:
            raise ValueError(
                f"{what}: {name} has {t.dim()} dimensions, expected {ndim}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of a CUDA device (a ``torch.device`` or an index; the current
    device when the index is unset): the launch shapes size their grids by
    it."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
