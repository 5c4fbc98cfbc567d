"""Flat rule table — the paper's comparator (a pandas-DataFrame stand-in).

The paper benchmarks the Trie of rules against "the popular in the field
data structure for a ruleset ... the Pandas data frame" (§4): one row per
rule with antecedent / consequent / metric columns, searched with full-column
boolean masks and sorted for top-N retrieval.

pandas is not a dependency of this package, so this module reproduces the
same data layout and cost model: object columns (tuples of frozensets),
full-column scans for search (that is what a pandas mask does), and a full
sort for top-N.  Keeping the comparator's asymptotics honest is what makes
the Fig. 8-13 reproductions meaningful.  A copy of ``repro.core.flat_table``.
"""
from __future__ import annotations

from typing import FrozenSet, Iterator, List, Optional, Sequence, Tuple

from .metrics import Item, Rule, RuleMetrics


class FlatRuleTable:
    """Row-per-rule table with column storage (dataframe semantics)."""

    def __init__(self) -> None:
        self.antecedents: List[FrozenSet[Item]] = []
        self.consequents: List[FrozenSet[Item]] = []
        self.support: List[float] = []
        self.confidence: List[float] = []
        self.lift: List[float] = []
        # Ordered forms kept for round-tripping / equivalence tests.
        self._ant_seq: List[Tuple[Item, ...]] = []
        self._con_seq: List[Tuple[Item, ...]] = []

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def append(self, rule: Rule) -> None:
        self.antecedents.append(frozenset(rule.antecedent))
        self.consequents.append(frozenset(rule.consequent))
        self.support.append(rule.metrics.support)
        self.confidence.append(rule.metrics.confidence)
        self.lift.append(rule.metrics.lift)
        self._ant_seq.append(tuple(rule.antecedent))
        self._con_seq.append(tuple(rule.consequent))

    @classmethod
    def from_rules(cls, rules: Sequence[Rule]) -> "FlatRuleTable":
        table = cls()
        for r in rules:
            table.append(r)
        return table

    # ------------------------------------------------------------------
    # the benchmarked operations
    # ------------------------------------------------------------------
    def search_rule(
        self,
        antecedent: Sequence[Item],
        consequent: Sequence[Item],
    ) -> Optional[RuleMetrics]:
        """Boolean-mask lookup: scan the full antecedent column, then the
        consequent column — the cost model of
        ``df[(df.antecedents == A) & (df.consequents == C)]``."""
        ant = frozenset(antecedent)
        con = frozenset(consequent)
        ant_mask = [a == ant for a in self.antecedents]
        con_mask = [c == con for c in self.consequents]
        for i, (ma, mc) in enumerate(zip(ant_mask, con_mask)):
            if ma and mc:
                return RuleMetrics(
                    self.support[i], self.confidence[i], self.lift[i]
                )
        return None

    def traverse(self) -> Iterator[Rule]:
        """Row-wise iteration over every rule (df.iterrows cost model)."""
        for i in range(len(self.support)):
            yield Rule(
                antecedent=self._ant_seq[i],
                consequent=self._con_seq[i],
                metrics=RuleMetrics(
                    self.support[i], self.confidence[i], self.lift[i]
                ),
            )

    def top_n(self, n: int, metric: str = "support") -> List[Rule]:
        """Full sort then head(n) — df.sort_values(metric).head(n)."""
        col = {
            "support": self.support,
            "confidence": self.confidence,
            "lift": self.lift,
        }[metric]
        order = sorted(range(len(col)), key=lambda i: col[i], reverse=True)
        out: List[Rule] = []
        for i in order[:n]:
            out.append(
                Rule(
                    antecedent=self._ant_seq[i],
                    consequent=self._con_seq[i],
                    metrics=RuleMetrics(
                        self.support[i], self.confidence[i], self.lift[i]
                    ),
                )
            )
        return out

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.support)

    def row(self, i: int) -> Rule:
        return Rule(
            antecedent=self._ant_seq[i],
            consequent=self._con_seq[i],
            metrics=RuleMetrics(
                self.support[i], self.confidence[i], self.lift[i]
            ),
        )

    def memory_cells(self) -> int:
        """Total stored cells (for the compression comparison): every row
        stores its full antecedent+consequent item lists plus 3 metrics."""
        items = sum(len(a) for a in self._ant_seq) + sum(
            len(c) for c in self._con_seq
        )
        return items + 3 * len(self.support)
