"""Fault-tolerant checkpointing: versioned, atomic, hash-verified, async.

PyTorch port of ``repro.train.checkpoint``, with its layout:
``<dir>/step_<N>/arrays.npz`` (the leaves as ``arr_0``, ``arr_1``, ... in
JAX's leaf order: dict keys sorted, lists and tuples in order, ``None`` an
empty subtree) and ``manifest.json`` (step, leaf count, the sha256 of
``arrays.npz``, a signature of the tree's structure, extra).  Writes go
to ``step_<N>.tmp``, are fsync'd and renamed only then, so a crash
mid-save never corrupts the latest checkpoint; ``restore_latest``
verifies the hash and the structure and falls back to the previous step
on a mismatch.  ``AsyncCheckpointer.save_async`` copies the leaves to
host memory (a device sync) before its one writer thread starts.

The structure signature hashes the string JAX prints for the same tree's
treedef (``_treedef_str``: e.g. ``PyTreeDef({'opt': {'m': (*,)},
'params': {'a': *, 'b': [*, *], 'n': None}})``), so each package restores
the other's checkpoints, optimizer state included.

bf16 leaves: numpy has no bfloat16 without ``ml_dtypes`` (the card's
host has none), so a bf16 leaf is stored as its raw 16-bit patterns in a
``|V2`` array, which is what ``np.savez`` writes for the reference's
``ml_dtypes`` bf16 leaves; on restore a ``|V2`` (or 16-bit integer) leaf
whose target is bf16 is read back bit for bit.  (The reference's own
restore casts with ``astype`` and cannot read such a leaf back.)
Restored leaves are tensors on the device of ``tree_like``'s leaves.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> List[Any]:
    """The leaves in JAX's order; ``None`` holds none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _treedef_str(tree) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts (string
    keys), lists, tuples, ``None`` and leaves."""
    def node(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({node(tree)})"


def _tree_sig(tree) -> str:
    return hashlib.sha256(_treedef_str(tree).encode()).hexdigest()[:16]


def _sha256(path: str) -> str:
    """The file's sha256 (the reference's digest of the whole file), over
    a read-only memory map: no copy of the file in memory."""
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        return hashlib.sha256(m).hexdigest()


def _to_numpy(x, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (a copy of a CPU tensor's memory with
    ``copy``); bf16 as its bit patterns in ``|V2``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.array(x) if copy else np.asarray(x)


def _host_tree(tree):
    return _unflatten(tree, [_to_numpy(x, copy=True) for x in _flatten(tree)])


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None):
    """Atomic checkpoint write; returns the final directory path."""
    leaves = [_to_numpy(x) for x in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, *leaves)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "sha256": _sha256(arrays_path),
        "treedef": _tree_sig(tree),
        "extra": extra or {},
    }
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """One background writer thread; ``wait()`` joins outstanding saves."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree, extra=None):
        self.wait()
        host_tree = _host_tree(tree)  # snapshot off-device (syncs)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = list_steps(self.ckpt_dir)
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                ignore_errors=True,
            )


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def _restore_leaf(a: np.ndarray, like) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype, shape and device."""
    if not isinstance(like, torch.Tensor):
        like = torch.as_tensor(np.asarray(like))
    a = np.asarray(a)
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and \
            a.dtype.kind in "Viu":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        t = t.to(like.dtype)
    return t.reshape(tuple(like.shape)).to(like.device)


def _load_step(ckpt_dir: str, step: int, tree_like):
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays_path = os.path.join(path, "arrays.npz")
    if _sha256(arrays_path) != manifest["sha256"]:
        raise IOError(f"checksum mismatch at step {step}")
    if _tree_sig(tree_like) != manifest["treedef"]:
        raise IOError(f"treedef mismatch at step {step}")
    leaves_like = _flatten(tree_like)
    with np.load(arrays_path) as data:
        leaves = [data[f"arr_{i}"] for i in range(manifest["n_leaves"])]
    restored = [_restore_leaf(l, like)
                for l, like in zip(leaves, leaves_like)]
    return _unflatten(tree_like, restored), manifest


def restore_latest(ckpt_dir: str, tree_like) -> Tuple[Any, Any]:
    """Newest valid checkpoint, falling back past corrupted ones.

    Returns (tree, manifest) or (None, None) when nothing restorable."""
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return _load_step(ckpt_dir, step, tree_like)
        except Exception:
            continue
    return None, None
