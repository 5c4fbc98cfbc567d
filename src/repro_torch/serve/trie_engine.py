"""Trie query serving: one front door over a trie on one device.

PyTorch port of ``repro.serve.trie_engine.TrieQueryEngine``, replicated
backend only: the whole trie lives on one device, uploaded once, with the
gathered column dicts memoized, and the batched ops route to
``kernels.ops``.  ``mode="auto"`` and ``mode="replicated"`` both serve
on that one device; the sharded backend (``mode="sharded"``, a ``mesh``
or an injected ``plan``) is ROADMAP slice 6 and raises
``NotImplementedError``, and ``plan`` reads ``None`` until then.  The
reference's ``shard_threshold_nodes`` only steers ``"auto"`` towards the
sharded backend, so it is left out with it.

The engine also fronts a ``core.delta_trie.StreamingTrie``: a frozen
base plus a mutable delta overlay.  Queries then run through
``kernels.streaming`` (frozen+delta k-best merges, bit-identical to a
from-scratch rebuild) on the stream's device, ``insert`` absorbs
new/updated rules, and ``maybe_refreeze`` runs the staggered fold.
``epoch`` exposes the stream's trie-version counter (bumps on every
insert and refreeze), so callers can tell whether a cached answer
predates the current trie contents.  ``frozen`` is a property for this
reason: a refreeze swaps the frozen base, and the engine never serves a
query half over the old trie and half over the new one.

``obs`` (an ``obs.Observability``, unset by default) wraps each op in an
``engine.<op>`` span on its tracer.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional, Sequence

from repro_torch.core.array_trie import FrozenTrie, resolve_device
from repro_torch.core.delta_trie import StreamingTrie
from repro_torch.kernels import ops as trie_ops


class TrieQueryEngine:
    """Serving front door for one Trie of Rules: a ``FrozenTrie`` on
    ``device`` (CUDA unless named), or a ``StreamingTrie`` on its own."""

    def __init__(self, frozen, device=None, *, mesh=None,
                 mode: str = "auto", plan=None):
        if mode not in ("auto", "replicated", "sharded"):
            raise ValueError(
                f"mode {mode!r} not in ('auto', 'replicated', 'sharded')"
            )
        if mode == "sharded" or mesh is not None or plan is not None:
            raise NotImplementedError(
                "TrieQueryEngine with mode='sharded', a mesh or a plan: "
                "the sharded backend is ROADMAP slice 6 (multi-GPU)"
            )
        # set by a serve component; when present, each op runs under an
        # ``engine.<op>`` span on the shared tracer
        self.obs = None
        self.stream = None
        self._frozen = None
        self.dt = None          # a frozen engine's DeviceTrie
        self._edges = None
        self._dfs_arrays = None
        self._item_arrays = None
        if isinstance(frozen, StreamingTrie):
            if device is not None and \
                    resolve_device(device) != frozen.device:
                raise ValueError(
                    f"the stream answers on {frozen.device}; build it "
                    f"with StreamingTrie(..., device={device!r})"
                )
            self.stream = frozen
            self.device = frozen.device
            return
        if type(frozen).__name__ == "ShardPlan":
            raise NotImplementedError(
                "TrieQueryEngine over a ShardPlan: the sharded backend is "
                "ROADMAP slice 6 (multi-GPU)"
            )
        if not isinstance(frozen, FrozenTrie):
            raise TypeError(
                f"TrieQueryEngine serves a FrozenTrie or a StreamingTrie, "
                f"not {type(frozen).__name__}"
            )
        self._frozen = frozen
        self.device = resolve_device(device)
        self.dt = frozen.device_arrays(device=self.device)

    # ------------------------------------------------------------------
    @property
    def frozen(self) -> FrozenTrie:
        """The current frozen base: re-read per call because a refreeze
        swaps it (the stream's epoch says which version answered)."""
        if self.stream is not None:
            return self.stream.frozen
        return self._frozen

    @property
    def epoch(self) -> int:
        """Trie-version counter (0 for a plain frozen engine): bumps on
        every insert and refreeze, so any result cache keyed on it can
        never return a pre-insert row for a post-insert trie."""
        return self.stream.epoch if self.stream is not None else 0

    @property
    def plan(self):
        """The engine's ``ShardPlan``: ``None`` until the sharded backend
        (ROADMAP slice 6)."""
        return None

    @property
    def backend(self) -> str:
        return "replicated"

    @property
    def n_shards(self) -> int:
        return 1

    def _span(self, name: str, **attrs):
        """Engine-level trace span (no-op context when obs is unset),
        parented under the tracer's current scoped span."""
        if self.obs is None:
            return nullcontext()
        return self.obs.tracer.span(
            name, backend=self.backend, shards=self.n_shards, **attrs
        )

    def _stream_base(self):
        """Residency override for ``kernels.streaming``: a sharded or
        dead-shard-masked base is ROADMAP slice 6, so it is ``None``
        (the stream routes itself through ``kernels.ops``)."""
        return None

    # ------------------------------------------------------------------
    # streaming mutation surface
    # ------------------------------------------------------------------
    def insert(self, sequences, support, confidence, lift) -> int:
        """Absorb inserted/updated rules into the delta overlay (bumps
        ``epoch``).  Requires a ``StreamingTrie``-backed engine."""
        if self.stream is None:
            raise TypeError(
                "insert requires a StreamingTrie-backed engine; build "
                "one with TrieQueryEngine(StreamingTrie(frozen), ...)"
            )
        return self.stream.insert(sequences, support, confidence, lift)

    def maybe_refreeze(self) -> Optional[int]:
        """Run one staggered fold step if the delta is over threshold;
        returns the folded depth-1 item (None when nothing folded)."""
        if self.stream is None:
            return None
        return self.stream.maybe_refreeze()

    # ------------------------------------------------------------------
    # the batched ops (thin routing over kernels.ops)
    # ------------------------------------------------------------------
    def rule_search_batch(self, queries, ant_len=None) -> Dict:
        with self._span("engine.rule_search_batch", n=len(queries)):
            if self.stream is not None:
                return trie_ops.rule_search_batch(
                    self.stream, queries, ant_len
                )
            if self._edges is None:
                self._edges = trie_ops.edge_metric_arrays(self.dt)
            # the FrozenTrie keeps ragged-pair canonicalization host-side
            return trie_ops.rule_search_batch(
                self._frozen, queries, ant_len, edges=self._edges
            )

    def top_k_rules_batch(self, prefixes, k: int,
                          metric: str = "confidence",
                          min_depth: int = 1) -> Dict:
        with self._span("engine.top_k_rules_batch", n=len(prefixes), k=k):
            if self.stream is not None:
                return trie_ops.top_k_rules_batch(
                    self.stream, prefixes, k, metric=metric,
                    min_depth=min_depth,
                )
            if self._dfs_arrays is None:
                self._dfs_arrays = trie_ops.dfs_rank_arrays(self.dt)
                self._dfs_arrays["_device_trie"] = self.dt
            return trie_ops.top_k_rules_batch(
                self._frozen, prefixes, k, metric=metric,
                min_depth=min_depth, arrays=self._dfs_arrays,
            )

    def rules_with(self, items: Sequence[int], role: str = "any",
                   k: int = 10, metric: str = "confidence",
                   min_depth: int = 1) -> Dict:
        with self._span("engine.rules_with", n=len(items), k=k):
            if self.stream is not None:
                return trie_ops.rules_with(
                    self.stream, items, role=role, k=k, metric=metric,
                    min_depth=min_depth,
                )
            if self._item_arrays is None:
                self._item_arrays = trie_ops.item_rank_arrays(self.dt)
            return trie_ops.rules_with(
                self._frozen, items, role=role, k=k, metric=metric,
                min_depth=min_depth, arrays=self._item_arrays,
            )

    def trie_reduce(self) -> Dict:
        """The traversal reduction over a frozen engine's trie; a stream
        has none (as in the reference) and raises
        ``NotImplementedError``."""
        with self._span("engine.trie_reduce"):
            if self.stream is not None:
                return trie_ops.trie_reduce(self.stream)
            return trie_ops.trie_reduce(self.dt)
