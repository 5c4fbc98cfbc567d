"""Deterministic, stateless-seekable, sharded token pipeline.

Restart semantics (fault tolerance): ``batch_at(step)`` is a pure function
of (seed, step), so resuming from a checkpoint at step N reproduces the
exact batch stream with no iterator state to persist.  Documents are packed
into fixed-length rows with ``segment_ids`` so attention never crosses
document boundaries (the model masks on them).  A copy of
``repro.data.pipeline`` (numpy only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .tokenizer import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    pack: bool = True


_WORDS = (
    "the of a to in rule trie mining support confidence lift node path "
    "data set tree fast search market basket item retail store apple "
    "bread milk beer diaper cheese wine fish rice tea coffee sugar salt "
    "paper code model train serve batch shard mesh pod chip kernel"
).split()


def synthetic_corpus(n_docs: int, seed: int = 0,
                     lo: int = 64, hi: int = 512) -> List[str]:
    """Offline corpus with Zipfian word draws + recurring boilerplate
    templates (gives the corpus-rule miner real structure to find)."""
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs /= probs.sum()
    boiler = "terms and conditions apply see store for details"
    docs = []
    for _ in range(n_docs):
        n = rng.randint(lo, hi)
        words = [
            _WORDS[i] for i in rng.choice(len(_WORDS), size=n, p=probs)
        ]
        if rng.rand() < 0.3:
            k = rng.randint(0, max(1, n - 1))
            words[k:k] = boiler.split()
        docs.append(" ".join(words))
    return docs


class TokenPipeline:
    """Packs a tokenized corpus into deterministic training batches."""

    def __init__(self, docs: Sequence[str], cfg: PipelineConfig,
                 tokenizer: Optional[ByteTokenizer] = None):
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer()
        self._rows, self._segs = self._pack(docs)

    def _pack(self, docs):
        s = self.cfg.seq_len + 1   # +1 for the shifted labels
        rows: List[np.ndarray] = []
        segs: List[np.ndarray] = []
        cur = np.full((s,), self.tok.pad_id, np.int32)
        seg = np.zeros((s,), np.int32)
        fill = 0
        seg_id = 1
        for doc in docs:
            ids = self.tok.encode(doc)
            i = 0
            while i < len(ids):
                take = min(len(ids) - i, s - fill)
                cur[fill : fill + take] = ids[i : i + take]
                seg[fill : fill + take] = seg_id
                fill += take
                i += take
                if fill == s:
                    rows.append(cur.copy())
                    segs.append(seg.copy())
                    cur[:] = self.tok.pad_id
                    seg[:] = 0
                    fill = 0
                    if not self.cfg.pack:
                        break
            seg_id += 1
        if fill > 0:
            rows.append(cur.copy())
            segs.append(seg.copy())
        return np.stack(rows), np.stack(segs)

    @property
    def n_rows(self) -> int:
        return self._rows.shape[0]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): the fault-tolerance contract."""
        rng = np.random.RandomState(
            (self.cfg.seed * 1_000_003 + step) % (2**31 - 1)
        )
        idx = rng.randint(0, self.n_rows, size=self.cfg.global_batch)
        rows = self._rows[idx]
        segs = self._segs[idx]
        return {
            "tokens": rows[:, :-1],
            "labels": rows[:, 1:],
            "segment_ids": segs[:, :-1],
            "loss_mask": (segs[:, 1:] > 0).astype(np.float32),
        }

    def batches(self, start_step: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
