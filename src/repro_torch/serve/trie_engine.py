"""Trie query serving: one front door over the replicated and sharded
backends.

PyTorch port of ``repro.serve.trie_engine``.  ``TrieQueryEngine`` owns a
frozen trie's device residency and routes the batched ops to one of two
bit-identical backends:

* ``"replicated"``: the whole trie on one device (``device``, CUDA unless
  named), uploaded once, with the gathered column dicts memoized.
* ``"sharded"``: the trie cut into contiguous DFS subtree ranges over a
  ``launch.mesh.TrieMesh`` (``distributed.trie_sharding.shard_device_trie``);
  each shard runs the kernels on its own device and the answers merge on
  the mesh's lead device, which is the engine's ``device`` (a ``device``
  that is not the lead is refused; the default mesh leads with it).

``mode="auto"`` picks sharded exactly when more than one CUDA device is
visible (and the engine is not asked for another device) and the trie
clears ``shard_threshold_nodes`` (default 64Ki nodes: below that a launch
sweeps a handful of tiles and the merge would dominate).  ``mesh=`` names
the devices; ``plan=`` hands in a ready ``ShardPlan`` (the resilience
ladder's dead-shard-masked one).  ``trie_reduce`` runs on the replicated
backend only, as the reference has no sharded reduction.

The engine also fronts a ``core.delta_trie.StreamingTrie``: a frozen
base plus a mutable delta overlay.  Queries then run through
``kernels.streaming`` (frozen+delta k-best merges, bit-identical to a
from-scratch rebuild) on the stream's device, with the frozen side
sharded over the stream's mesh on the sharded backend; ``insert``
absorbs new/updated rules, and ``maybe_refreeze`` runs the staggered
fold.  ``epoch`` exposes the stream's trie-version counter (bumps on
every insert and refreeze), so callers can tell whether a cached answer
predates the current trie contents.  ``frozen`` and ``plan`` are
properties for this reason: a refreeze swaps the frozen base, and the
engine never serves a query half over the old trie and half over the
new one.

``obs`` (an ``obs.Observability``, unset by default) wraps each op in an
``engine.<op>`` span on its tracer.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.array_trie import FrozenTrie, resolve_device
from repro_torch.core.delta_trie import StreamingTrie
from repro_torch.kernels import ops as trie_ops

DEFAULT_SHARD_THRESHOLD = 1 << 16   # nodes


def _default_mesh(device):
    """Every visible CUDA device, ``device`` first (the lead, where the
    answers merge), on a CUDA ``device``; the one device otherwise."""
    from repro_torch.launch.mesh import TrieMesh

    lead = TrieMesh([device]).lead
    if lead.type != "cuda":
        return TrieMesh([lead])
    return TrieMesh([lead] + [torch.device("cuda", i)
                              for i in range(torch.cuda.device_count())
                              if i != lead.index])


def _check_lead(device, lead, what: str) -> None:
    """Refuse a ``device`` other than the sharded backend's lead device,
    where its answers merge."""
    from repro_torch.launch.mesh import TrieMesh

    if device is not None and \
            TrieMesh([resolve_device(device)]).lead != lead:
        raise ValueError(
            f"the sharded backend answers on {what}'s lead device {lead}, "
            f"not on {device!r}"
        )


class TrieQueryEngine:
    """Serving front door for one Trie of Rules: a ``FrozenTrie`` or a
    ``StreamingTrie``, on one device or sharded over a mesh."""

    def __init__(self, frozen, device=None, *, mesh=None,
                 mode: str = "auto",
                 shard_threshold_nodes: int = DEFAULT_SHARD_THRESHOLD,
                 plan=None):
        if mode not in ("auto", "replicated", "sharded"):
            raise ValueError(
                f"mode {mode!r} not in ('auto', 'replicated', 'sharded')"
            )
        # set by a serve component; when present, each op runs under an
        # ``engine.<op>`` span on the shared tracer
        self.obs = None
        self.stream = None
        self._frozen = None
        self._plan = None
        self._stream_sharded = False
        self.dt = None          # a replicated frozen engine's DeviceTrie
        self._edges = None
        self._dfs_arrays = None
        self._item_arrays = None
        if isinstance(frozen, StreamingTrie):
            self.stream = frozen
        elif isinstance(frozen, FrozenTrie):
            self._frozen = frozen
        else:
            raise TypeError(
                f"TrieQueryEngine serves a FrozenTrie or a StreamingTrie, "
                f"not {type(frozen).__name__}"
            )
        if plan is not None:
            # a ready (possibly dead-shard-masked) ShardPlan: the
            # resilience ladder's degraded engines hand theirs straight
            # in.  With a stream the plan answers the frozen side.
            _check_lead(device, plan.device, "the plan")
            self._plan = plan
            self.mesh = plan.mesh
            self.device = plan.device
            return
        if self.stream is not None:
            if device is not None and \
                    resolve_device(device) != self.stream.device:
                raise ValueError(
                    f"the stream answers on {self.stream.device}; build it "
                    f"with StreamingTrie(..., device={device!r})"
                )
            dev = self.stream.device
        else:
            # a mesh alone names the lead device
            dev = resolve_device(mesh.lead if device is None and
                                 mesh is not None else device)
        if mesh is None and mode == "auto" and dev.type == "cuda" and \
                torch.cuda.device_count() > 1:
            mesh = _default_mesh(dev)
        n_dev = int(mesh.shape["data"]) if mesh is not None else 1
        sharded = mode == "sharded" or (
            mode == "auto" and n_dev > 1
            and self.frozen.n_nodes >= shard_threshold_nodes
        )
        if self.stream is not None:
            if sharded:
                if self.stream.mesh is not None:
                    mesh = self.stream.mesh
                else:
                    # the engine owns residency: hand the stream its mesh
                    # before any plan is cached
                    self.stream.mesh = mesh if mesh is not None else \
                        _default_mesh(dev)
                    mesh = self.stream.mesh
                self._stream_sharded = True
            self.mesh = mesh
            self.device = dev
            return
        self.mesh = mesh
        if sharded:
            from repro_torch.distributed.trie_sharding import (
                shard_device_trie,
            )

            if mesh is None:
                self.mesh = _default_mesh(dev)
            _check_lead(device, self.mesh.lead, "the mesh")
            self._plan = shard_device_trie(frozen, self.mesh)
            self.device = self._plan.device
            return
        self.device = dev
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
        """The sharded backend's ``ShardPlan`` (a stream's current one),
        ``None`` on the replicated backend."""
        if self.stream is not None and self._plan is None:
            return self.stream.shard_plan() if self._stream_sharded \
                else None
        return self._plan

    @property
    def backend(self) -> str:
        return "sharded" if self.plan is not None else "replicated"

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards if self.plan is not None else 1

    def _span(self, name: str, **attrs):
        """Engine-level trace span (no-op context when obs is unset),
        parented under the tracer's current scoped span."""
        if self.obs is None:
            return nullcontext()
        return self.obs.tracer.span(
            name, backend=self.backend, shards=self.n_shards, **attrs
        )

    def _stream_base(self):
        """Residency override handed to ``kernels.streaming``: an
        injected (dead-shard-masked) plan wins; a replicated engine over
        a mesh-bearing stream pins the frozen base instead of the
        stream's plan; ``None`` lets the stream route itself (through
        the validating ``kernels.ops`` dispatch)."""
        if self._plan is not None:
            return self._plan
        if self.stream.mesh is not None and not self._stream_sharded:
            return self.stream.frozen
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
                base = self._stream_base()
                if base is None:
                    return trie_ops.rule_search_batch(
                        self.stream, queries, ant_len
                    )
                from repro_torch.kernels.streaming import (
                    streaming_rule_search_batch,
                )

                return streaming_rule_search_batch(
                    self.stream, queries, ant_len, base=base
                )
            if self.plan is not None:
                return trie_ops.rule_search_batch(self.plan, queries,
                                                  ant_len)
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
                base = self._stream_base()
                if base is None:
                    return trie_ops.top_k_rules_batch(
                        self.stream, prefixes, k, metric=metric,
                        min_depth=min_depth,
                    )
                from repro_torch.kernels.streaming import (
                    streaming_top_k_rules_batch,
                )

                return streaming_top_k_rules_batch(
                    self.stream, prefixes, k, metric=metric,
                    min_depth=min_depth, base=base,
                )
            if self.plan is not None:
                return trie_ops.top_k_rules_batch(
                    self.plan, prefixes, k, metric=metric,
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
                base = self._stream_base()
                if base is None:
                    return trie_ops.rules_with(
                        self.stream, items, role=role, k=k, metric=metric,
                        min_depth=min_depth,
                    )
                from repro_torch.kernels.streaming import (
                    streaming_rules_with,
                )

                return streaming_rules_with(
                    self.stream, items, role=role, k=k, metric=metric,
                    min_depth=min_depth, base=base,
                )
            if self.plan is not None:
                return trie_ops.rules_with(
                    self.plan, items, role=role, k=k, metric=metric,
                    min_depth=min_depth,
                )
            if self._item_arrays is None:
                self._item_arrays = trie_ops.item_rank_arrays(self.dt)
            return trie_ops.rules_with(
                self._frozen, items, role=role, k=k, metric=metric,
                min_depth=min_depth, arrays=self._item_arrays,
            )

    def trie_reduce(self) -> Dict:
        """The traversal reduction over a replicated frozen engine's trie;
        a stream or a plan has none (as in the reference) and raises
        ``NotImplementedError``."""
        with self._span("engine.trie_reduce"):
            if self.stream is not None:
                return trie_ops.trie_reduce(self.stream)
            if self.plan is not None:
                return trie_ops.trie_reduce(self.plan)
            return trie_ops.trie_reduce(self.dt)


def make_trie_engine(
    frozen,
    device=None,
    *,
    mesh=None,
    mode: str = "auto",
    shard_threshold_nodes: int = DEFAULT_SHARD_THRESHOLD,
) -> TrieQueryEngine:
    """Factory alias (the reference's ``make_trie_engine``): ``frozen``
    may be a ``FrozenTrie`` or a ``StreamingTrie``."""
    return TrieQueryEngine(
        frozen, device, mesh=mesh, mode=mode,
        shard_threshold_nodes=shard_threshold_nodes,
    )
