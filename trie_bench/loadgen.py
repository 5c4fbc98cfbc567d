"""The one traffic generator: reads a mix's parameters and draws a
deterministic stream of queries over the served ruleset's real paths.

A generalized copy of the port's ``serve.faults.zipfian_workload``: the
same three ops and kwargs, with the sizes that decide what the serve
loop's cache can do made parameters.  The port's own generator caps each
op's pool of distinct queries at 64, which its scheduler's 1,024-entry LRU
holds whole; here the pool is a parameter, or absent (every query drawn
uniformly from all that the op can ask), and so are the op mix, k, the
depth of the top-k prefixes and the number of closed-loop clients.

A mix file (``traffic/<name>.json``) holds::

    clients            closed-loop clients, each waiting for its reply
    op_mix             {"rule_search": p, "top_k": p, "rules_with": p}
    pool               distinct queries per op (Zipf-ranked), or null for
                       uniform draws over every query the op can ask
    zipf_s             Zipf exponent over a pool's popularity ranks
    k                  results per ranked query
    top_k              {"metric": m, "prefix_depth": d or null}
    rules_with         {"role": r, "metric": m, "items": "trie"}
    warmup_requests    requests served before the window opens
    why, source, assumed   what the mix is for, and where its numbers
                       come from (read by people, not here)

The queries of an op form its universe, ordered by path so that the
stream depends on the ruleset and the seed and not on how the program
numbers its nodes:

* ``rule_search``: every rule path, split into antecedent and consequent
  at a cut drawn from 1 to its length (an empty consequent re-asks the
  antecedent, a miss, as the port's generator does); query id
  ``path * 64 + cut``.
* ``top_k``: every path of at most ``prefix_depth`` items as a prefix.
* ``rules_with``: every item of the trie (``trie``), the items that
  have rules.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

OPS = ("rule_search", "top_k", "rules_with")
CUT = 64            # query id = path index * CUT + cut
CHUNK = 1 << 16     # requests drawn per chunk of the stream


def item_paths(node_parent: np.ndarray, node_item: np.ndarray,
               node_depth: np.ndarray) -> np.ndarray:
    """``int64 [N, D]``: every node's root path of items, -1 padded."""
    parent = np.asarray(node_parent, np.int64)
    item = np.asarray(node_item, np.int64)
    depth = np.asarray(node_depth, np.int64)
    n = parent.shape[0]
    width = int(depth.max()) if n > 1 else 0
    path = np.full((n, max(width, 1)), -1, np.int64)
    for d in range(1, width + 1):
        ids = np.nonzero(depth == d)[0]
        path[ids, : d - 1] = path[parent[ids], : d - 1]
        path[ids, d - 1] = item[ids]
    return path


class Traffic:
    """The stream of one mix over one ruleset, from ``seed``."""

    def __init__(self, mix: dict, paths: np.ndarray, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.clients = int(mix["clients"])
        self.warmup = int(mix["warmup_requests"])
        self.k = int(mix["k"])
        probs = np.array([float(mix["op_mix"][op]) for op in OPS])
        if probs.min() < 0 or probs.sum() <= 0:
            raise ValueError(f"op_mix {mix['op_mix']} is no distribution")
        self.op_p = probs / probs.sum()
        tk, rw = mix["top_k"], mix["rules_with"]
        self.kwargs = {
            "rule_search": {},
            "top_k": {"k": self.k, "metric": tk["metric"]},
            "rules_with": {"role": rw["role"], "k": self.k,
                           "metric": rw["metric"]},
        }

        # the rule paths, by path order (rows of -1-padded items)
        depth = (paths >= 0).sum(axis=1)
        real = np.nonzero(depth > 0)[0]
        keys = tuple(paths[real, c] for c in range(paths.shape[1] - 1, -1, -1))
        real = real[np.lexsort(keys)]
        self.depth = depth[real]
        self.paths: List[Tuple[int, ...]] = [
            tuple(row[:d]) for row, d in zip(paths[real].tolist(),
                                             self.depth.tolist())
        ]
        n_paths = len(self.paths)
        if n_paths == 0:
            raise ValueError("the ruleset has no rule to query")
        pdepth = tk.get("prefix_depth")
        prefixes = np.arange(n_paths) if pdepth is None else \
            np.nonzero(self.depth <= int(pdepth))[0]
        if rw["items"] != "trie":
            raise ValueError(f"rules_with items {rw['items']!r} not in "
                             "('trie',)")
        items = np.unique(paths[paths >= 0])
        self.universe = {"rule_search": np.arange(n_paths),
                         "top_k": prefixes, "rules_with": items}

        rng = np.random.default_rng([self.seed, 1 << 40])
        self.pool = {}
        self.pool_cut = None
        self.pool_p = None
        if mix.get("pool") is not None:
            size = int(mix["pool"])
            for op in OPS:
                u = self.universe[op]
                self.pool[op] = rng.choice(u, size=min(size, u.shape[0]),
                                           replace=False)
            pr = self.pool["rule_search"]
            self.pool_cut = rng.integers(1, self.depth[pr] + 1)
            self.pool_p = {}
            for op in OPS:
                ranks = np.arange(1, self.pool[op].shape[0] + 1,
                                  dtype=np.float64)
                p = ranks ** -float(mix["zipf_s"])
                self.pool_p[op] = p / p.sum()
        self._chunk = -1
        self._ops: List[int] = []
        self._qids: List[int] = []
        self._i = 0

    # ------------------------------------------------------------------
    def draw(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """Chunk ``c`` of the stream: ``(op index, query id)`` arrays."""
        rng = np.random.default_rng([self.seed, c])
        ops = rng.choice(len(OPS), size=CHUNK, p=self.op_p)
        qids = np.zeros(CHUNK, np.int64)
        for o, op in enumerate(OPS):
            sel = np.nonzero(ops == o)[0]
            if op in self.pool:
                j = rng.choice(self.pool[op].shape[0], size=sel.shape[0],
                               p=self.pool_p[op])
                q = self.pool[op][j]
                if op == "rule_search":
                    q = q * CUT + self.pool_cut[j]
            else:
                u = self.universe[op]
                q = u[rng.integers(0, u.shape[0], size=sel.shape[0])]
                if op == "rule_search":
                    q = q * CUT + rng.integers(1, self.depth[q] + 1)
            qids[sel] = q
        return ops, qids

    def next(self) -> Tuple[int, int]:
        """The next request of the stream: ``(op index, query id)``."""
        if self._i >= len(self._ops):
            self._chunk += 1
            ops, qids = self.draw(self._chunk)
            self._ops, self._qids, self._i = ops.tolist(), qids.tolist(), 0
        i = self._i
        self._i += 1
        return self._ops[i], self._qids[i]

    def payload(self, op: int, qid: int):
        """What a client sends for a query."""
        if op == 0:
            path = self.paths[qid // CUT]
            cut = qid % CUT
            ant, con = list(path[:cut]), list(path[cut:])
            return (ant, con or ant)
        if op == 1:
            return list(self.paths[qid])
        return int(qid)

    def rule_pairs(self, qids: Sequence[int]):
        return [self.payload(0, int(q)) for q in qids]

    def prefixes(self, qids: Sequence[int]):
        return [self.paths[int(q)] for q in qids]

    def describe(self) -> Dict[str, int]:
        """The sizes the mix draws from, for the run's log."""
        return {op: int((self.pool.get(op, self.universe[op])).shape[0])
                for op in OPS}
