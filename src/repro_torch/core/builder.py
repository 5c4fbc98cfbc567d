"""The paper's three-step pipeline (Fig. 2): miner → trie → annotate.

``build_trie_of_rules`` is the public constructor used by benchmarks,
examples and the data-pipeline integration.  Two construction engines are
selectable via ``engine``:

* ``"pointer"`` (default) — the paper-faithful per-node Python pipeline:
  ``TrieOfRules.build`` dict inserts + per-node ``support_fn`` annotation.
  Kept as the reproduction baseline and the parity oracle.
* ``"arrays"`` — the array-native production path
  (``core.build_arrays.build_frozen_trie``): vectorized prefix dedup over
  the canonical sequence matrix + ONE batched support pass (host bitmap
  AND or the CUDA ``support_count`` kernel), emitting the ``FrozenTrie``
  encoding directly.  Benchmarks and examples default to this engine.
* ``"both"`` — build the two in one mine (benchmark comparisons); pointer
  timings land in ``build/annotate_seconds`` and array timings in
  ``array_build/annotate_seconds``.

``use_kernel`` threads the CUDA ``support_count`` kernel end to end, on
``device`` (CUDA unless named): mining Step 1 candidate counting
(``apriori(use_kernel=True)``, one launch per level) and the arrays
engine's Step 3 annotation (one launch) both route through it; ``None``
means the kernel, ``False`` the vectorized numpy host paths.  A copy of
``repro.core.builder``, with ``device``.

``build_flat_table`` builds the comparator ``FlatRuleTable`` from the
identical canonical ruleset so every evaluation compares the same
information in two representations.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from typing import TYPE_CHECKING

from .array_trie import FrozenTrie
from .flat_table import FlatRuleTable
from .metrics import Item, Rule
from .trie import TrieOfRules

if TYPE_CHECKING:  # avoid the core ↔ arm import cycle at runtime
    from repro_torch.arm.transactions import TransactionDB

ItemSet = FrozenSet[Item]

ENGINES = ("pointer", "arrays", "both")


def _miners() -> Dict[str, Callable]:
    from repro_torch.arm.apriori import apriori
    from repro_torch.arm.fpgrowth import fpgrowth, fpmax

    return {"fpgrowth": fpgrowth, "fpmax": fpmax, "apriori": apriori}


@dataclass
class BuildResult:
    trie: Optional[TrieOfRules]
    sequences: List[Tuple[Item, ...]]
    itemsets: Dict[ItemSet, int]
    mine_seconds: float
    build_seconds: float       # Step 2 (structure) of the selected engine
    annotate_seconds: float    # Step 3 (metric labelling) of that engine
    frozen: Optional[FrozenTrie] = None   # arrays/both engines fill this
    engine: str = "pointer"
    # arrays-engine timings when engine="both" (mirrors of build/annotate
    # when engine="arrays")
    array_build_seconds: float = 0.0
    array_annotate_seconds: float = 0.0

    @property
    def construct_seconds(self) -> float:
        return self.build_seconds + self.annotate_seconds

    @property
    def array_construct_seconds(self) -> float:
        return self.array_build_seconds + self.array_annotate_seconds

    def freeze(self) -> FrozenTrie:
        """The SoA/CSR/DFS encoding: the arrays-engine output when one was
        built, else a (cached) ``FrozenTrie.freeze`` of the pointer trie."""
        if self.frozen is None:
            self.frozen = FrozenTrie.freeze(self.trie)
        return self.frozen


def build_trie_of_rules(
    db: "TransactionDB",
    min_support: float,
    miner: str = "fpmax",
    max_len: int = 12,
    engine: str = "pointer",
    use_kernel: Optional[bool] = None,
    device=None,
) -> BuildResult:
    """Step 1 (mine) → Step 2 (insert) → Step 3 (annotate)."""
    from repro_torch.arm.rulegen import canonical_sequences  # lazy: import cycle

    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    mine_fn = _miners()[miner]
    mine_kwargs = {"max_len": max_len}
    if miner == "apriori":
        # None means the kernel, like Step-3 annotation
        mine_kwargs["use_kernel"] = use_kernel is None or bool(use_kernel)
        mine_kwargs["device"] = device
    t0 = time.perf_counter()
    itemsets = mine_fn(db, min_support, **mine_kwargs)
    t1 = time.perf_counter()

    sequences = canonical_sequences(itemsets.keys(), db)
    # shared miner-output prep, billed to NEITHER engine (each engine
    # re-canonicalizes internally: pointer insert per sequence, arrays
    # vectorized) so the two construct timings stay comparable
    t_seq = time.perf_counter()

    trie: Optional[TrieOfRules] = None
    build_secs = annotate_secs = 0.0
    if engine in ("pointer", "both"):
        trie = TrieOfRules(item_order=db.frequency_order())
        trie.build(sequences)
        t2 = time.perf_counter()
        trie.annotate(db.support_fn())
        build_secs = t2 - t_seq
        annotate_secs = time.perf_counter() - t2

    frozen: Optional[FrozenTrie] = None
    arr_build = arr_annotate = 0.0
    if engine in ("arrays", "both"):
        from .build_arrays import build_frozen_trie

        frozen, arr_build, arr_annotate = build_frozen_trie(
            db, sequences, use_kernel=use_kernel, device=device
        )
        if engine == "arrays":
            build_secs, annotate_secs = arr_build, arr_annotate

    return BuildResult(
        trie=trie,
        sequences=sequences,
        itemsets=itemsets,
        mine_seconds=t1 - t0,
        build_seconds=build_secs,
        annotate_seconds=annotate_secs,
        frozen=frozen,
        engine=engine,
        array_build_seconds=arr_build,
        array_annotate_seconds=arr_annotate,
    )


def build_flat_table(
    db: "TransactionDB",
    itemsets: Dict[ItemSet, int],
    min_confidence: float = 0.0,
) -> Tuple[FlatRuleTable, List[Rule], float]:
    """The dataframe comparator over the identical canonical ruleset."""
    from repro_torch.arm.rulegen import prefix_split_rules  # lazy: import cycle

    t0 = time.perf_counter()
    rules = prefix_split_rules(itemsets, db, min_confidence=min_confidence)
    table = FlatRuleTable.from_rules(rules)
    return table, rules, time.perf_counter() - t0
