"""Transaction database with a packed-bitmap vertical layout.

Layout (ECLAT-style vertical): ``item_bitmaps[i]`` is the transaction set of
item ``i`` packed into uint32 words — shape ``(n_items, n_words)`` with
``n_words = ceil(n_transactions / 32)``.  Support of an itemset is then
``popcount(AND over its item rows)``; that AND+popcount inner loop is the
mining hot spot, and ``repro_torch.kernels.support_count`` runs it on the
GPU over these same bitmaps.  A copy of ``repro.arm.transactions``, with a
``device`` for the kernel path and a host path that skips a ``-1`` entry
anywhere in a row.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Item = int

def popcount_u32(words: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array.

    Uses the native SIMD ufunc on numpy>=2, else a SWAR bit-twiddle —
    both single-pass, ~10x the old byte-table gather (which dominated
    batched annotation profiles)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).astype(np.uint32)
    x = words.astype(np.uint32, copy=True)
    x -= (x >> np.uint32(1)) & np.uint32(0x55555555)
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)


class TransactionDB:
    """Immutable transaction database over integer items ``0..n_items-1``."""

    def __init__(
        self, transactions: Sequence[Iterable[Item]], n_items: int
    ) -> None:
        self.transactions: List[FrozenSet[Item]] = [
            frozenset(t) for t in transactions
        ]
        self.n_transactions = len(self.transactions)
        self.n_items = n_items
        self.n_words = (self.n_transactions + 31) // 32
        self.item_bitmaps = np.zeros(
            (n_items, self.n_words), dtype=np.uint32
        )
        for tid, t in enumerate(self.transactions):
            word, bit = divmod(tid, 32)
            mask = np.uint32(1) << np.uint32(bit)
            for it in t:
                if not (0 <= it < n_items):
                    raise ValueError(f"item {it} out of range [0,{n_items})")
                self.item_bitmaps[it, word] |= mask
        self._item_counts = popcount_u32(self.item_bitmaps).sum(axis=1)
        self._support_cache: Dict[FrozenSet[Item], int] = {}
        self._device_bitmaps: Dict[str, object] = {}

    def device_bitmaps(self, device=None):
        """``item_bitmaps`` as an int32 tensor on ``device`` (CUDA unless
        named; the same bits, viewed signed), uploaded once per device."""
        import torch

        from repro_torch.core.array_trie import resolve_device

        dev = resolve_device(device)
        bm = self._device_bitmaps.get(str(dev))
        if bm is None:
            bm = torch.from_numpy(
                self.item_bitmaps.view(np.int32).reshape(-1)
            ).reshape(self.item_bitmaps.shape).to(dev)
            self._device_bitmaps[str(dev)] = bm
        return bm

    def all_transactions(self) -> np.ndarray:
        """uint32 ``[n_words]``: every transaction's bit set, the padding
        bits past the last transaction clear (Support(∅) as a bitmap)."""
        root = np.full((self.n_words,), 0xFFFFFFFF, np.uint32)
        tail = self.n_transactions % 32
        if self.n_words and tail:
            root[-1] = np.uint32((1 << tail) - 1)
        return root

    # ------------------------------------------------------------------
    # supports
    # ------------------------------------------------------------------
    def item_counts(self) -> np.ndarray:
        """Absolute frequency of every item, shape (n_items,)."""
        return self._item_counts.copy()

    def frequency_order(self) -> List[Item]:
        """Items by descending frequency (ties → ascending id) — the global
        order the paper sorts every sequence with before insertion."""
        counts = self._item_counts
        return sorted(
            range(self.n_items), key=lambda i: (-int(counts[i]), i)
        )

    def itemset_count(self, itemset: Iterable[Item]) -> int:
        """Exact transaction count of an itemset (AND + popcount)."""
        key = frozenset(itemset)
        cached = self._support_cache.get(key)
        if cached is not None:
            return cached
        if not key:
            count = self.n_transactions
        else:
            acc = None
            for it in key:
                row = self.item_bitmaps[it]
                acc = row if acc is None else (acc & row)
            count = int(popcount_u32(acc).sum())
        self._support_cache[key] = count
        return count

    def support(self, itemset: Iterable[Item]) -> float:
        return self.itemset_count(itemset) / self.n_transactions

    def support_fn(self):
        """Closure used by ``TrieOfRules.annotate`` (Step 3)."""
        return lambda itemset: self.support(itemset)

    def support_batch(
        self,
        candidates: np.ndarray,
        lengths: Optional[np.ndarray] = None,
        use_kernel: bool = False,
        chunk: int = 8192,
        device=None,
    ) -> np.ndarray:
        """Exact transaction counts for a whole candidate matrix at once.

        ``candidates`` is the padded int32 ``[C, K]`` itemset matrix
        (``candidate_matrix`` layout, -1 padding).  This is the batched
        replacement for per-itemset ``itemset_count`` calls: the default
        path ANDs the vertical bitmaps for ``chunk`` candidates at a time
        (vectorized, no Python-per-candidate work); ``use_kernel=True``
        routes the whole batch through ``kernels.ops.support_count`` on
        ``device`` (CUDA unless named) in ONE kernel launch.  Each row
        counts the transactions holding every valid (non-negative) item
        it has, wherever in the row the item sits; rows with ``lengths <=
        0``, and rows with no valid item, count every transaction
        (Support(∅) = |D|), matching ``itemset_count``.
        """
        mat = np.asarray(candidates, dtype=np.int64)
        if mat.ndim != 2:
            raise ValueError("candidates must be [C, K]")
        c = mat.shape[0]
        lens = (
            (mat >= 0).sum(axis=1)
            if lengths is None else np.asarray(lengths, np.int64)
        )
        if bool((mat >= self.n_items).any()):
            raise ValueError(f"item out of range [0,{self.n_items})")
        if use_kernel and c:
            from repro_torch.kernels.ops import support_count

            counts = support_count(
                mat.astype(np.int32),
                np.where(lens > 0, lens, -1).astype(np.int32),
                self.device_bitmaps(device),
                n_transactions=self.n_transactions,
                device=device,
            ).cpu().numpy().astype(np.int64)
        else:
            counts = np.zeros((c,), dtype=np.int64)
            # columns a row needs: up to its last valid item
            valid = mat >= 0
            reach = np.zeros((c,), np.int64)
            if valid.size:
                last = mat.shape[1] - np.argmax(valid[:, ::-1], axis=1)
                reach = np.where(valid.any(axis=1), last, 0)
            # Process rows reach-sorted so column k touches only the rows
            # that still have a valid item at or past k (annotation batches
            # are depth-skewed); a sentinel row of every transaction absorbs
            # the -1 entries without a per-column ``where`` pass, and seeds
            # each row, so a row with no valid item counts |D|.
            order = np.argsort(reach, kind="stable")
            root = self.all_transactions()
            bm = np.concatenate([self.item_bitmaps, root[None, :]], axis=0)
            step = max(chunk, 1)
            for lo in range(0, c, step):
                rows = order[lo:lo + step]
                m = mat[rows]
                mr = reach[rows]
                acc = np.repeat(root[None, :], m.shape[0], axis=0)
                for k in range(m.shape[1]):
                    start = int(np.searchsorted(mr, k + 1))
                    if start >= m.shape[0]:
                        break
                    col = m[start:, k]
                    idx = np.where(col >= 0, col, self.n_items)
                    acc[start:] &= bm[idx]
                counts[rows] = popcount_u32(acc).sum(axis=1, dtype=np.int64)
        counts[lens <= 0] = self.n_transactions
        return counts

    # ------------------------------------------------------------------
    # batched layout for the support kernel
    # ------------------------------------------------------------------
    def candidate_matrix(
        self, itemsets: Sequence[Sequence[Item]], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack candidates into a dense (n_candidates, max_len) int32 matrix
        padded with -1, plus lengths — the input of the support kernel."""
        n = len(itemsets)
        mat = np.full((n, max_len), -1, dtype=np.int32)
        lens = np.zeros((n,), dtype=np.int32)
        for i, s in enumerate(itemsets):
            s = list(s)
            if len(s) > max_len:
                raise ValueError("itemset longer than max_len")
            mat[i, : len(s)] = s
            lens[i] = len(s)
        return mat, lens

    def __len__(self) -> int:
        return self.n_transactions
