"""Faults planted under the timed path.  Each must make the comparison find
a run not correct; the benchmark's tests plant them at a small size on the
CPU and ``readings.py --faults`` at a cell's own size on the card.

* ``AlteredAnswer`` (an engine wrapper): every launch's first answer is
  altered where it is produced: a rule's Confidence, or a ranking's best
  value, off by one part in a hundred.
* ``HalfBatch`` (an engine wrapper): every launch computes only the first
  half of its rows; the rest come back empty (not found, no ranked node).
* ``unannotated`` (a trie fault): the built trie's Lift column is left
  unannotated (zeros), as if set-up had skipped that pass.

The exchange between chips has no fault here: every cell runs on one chip.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .serve_loop import EngineWrapper


class AlteredAnswer(EngineWrapper):
    def _call(self, name, args, kwargs):
        out = dict(super()._call(name, args, kwargs))
        key = "values" if "values" in out else "confidence"
        v = out[key].clone()
        first = v.view(v.shape[0], -1)
        first[0, 0] = first[0, 0] * 1.01 + 0.01
        out[key] = v
        return out


def _empty_like(out, n):
    """``n`` empty answer rows in the fields and types of ``out``."""
    fill = {"node": -1, "values": -np.inf}
    return {k: torch.full((n, *v.shape[1:]), fill.get(k, 0), dtype=v.dtype,
                          device=v.device)
            for k, v in out.items()}


class HalfBatch(EngineWrapper):
    def _call(self, name, args, kwargs):
        n = len(args[0])
        half = (n + 1) // 2
        # every per-row argument (the rows, a search's antecedent lengths)
        head = tuple(a[:half] if hasattr(a, "__len__") and len(a) == n
                     else a for a in args)
        out = super()._call(name, head, kwargs)
        tail = _empty_like(out, n - half)
        return {k: torch.cat([v[:half], tail[k]]) for k, v in out.items()}


def unannotated(frozen):
    return dataclasses.replace(frozen, lift=np.zeros_like(frozen.lift))


ENGINE_FAULTS = {"altered_answer": AlteredAnswer, "half_batch": HalfBatch}
TRIE_FAULTS = {"unannotated": unannotated}


def hooks(name: str) -> dict:
    """The ``run.main`` hooks that plant fault ``name``."""
    if name in ENGINE_FAULTS:
        return {"engine": ENGINE_FAULTS[name]}
    if name in TRIE_FAULTS:
        return {"frozen": TRIE_FAULTS[name]}
    raise KeyError(f"no fault {name!r}: "
                   f"{sorted(ENGINE_FAULTS) + sorted(TRIE_FAULTS)}")
