"""Rule evaluation metrics (paper §2.2, §3.2).

Support, Confidence, Lift over a transaction database, plus the paper's
compound-consequent Confidence identity (Eq. 1-4):

    Conf(A,B -> C,D) = Conf(A,B -> C) * Conf(A,B,C -> D)

which holds because every trie path stores the exact Support of the full
prefix (support monotonicity along a path).

All functions here are host-side scalar math used by the paper-faithful
pointer trie; the vectorized column versions live in ``array_trie.py``.
A copy of ``repro.core.metrics``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Sequence, Tuple

Item = int
ItemSet = FrozenSet[Item]


@dataclass(frozen=True)
class RuleMetrics:
    """Metric bundle attached to every rule / trie node (paper Step 3)."""

    support: float        # Support(A ∪ C)
    confidence: float     # Support(A ∪ C) / Support(A)
    lift: float           # Confidence / Support(C)

    def as_dict(self) -> Dict[str, float]:
        return {
            "support": self.support,
            "confidence": self.confidence,
            "lift": self.lift,
        }


def support(count: int, n_transactions: int) -> float:
    """Support = |transactions containing the itemset| / |D|."""
    if n_transactions <= 0:
        raise ValueError("n_transactions must be positive")
    return count / n_transactions


def confidence(support_rule: float, support_antecedent: float) -> float:
    """Confidence(X=>Y) = Support(X∪Y) / Support(X)."""
    if support_antecedent <= 0.0:
        return 0.0
    return support_rule / support_antecedent


def lift(confidence_value: float, support_consequent: float) -> float:
    """Lift(X=>Y) = Confidence(X=>Y) / Support(Y)."""
    if support_consequent <= 0.0:
        return 0.0
    return confidence_value / support_consequent


def rule_metrics(
    support_rule: float,
    support_antecedent: float,
    support_consequent: float,
) -> RuleMetrics:
    conf = confidence(support_rule, support_antecedent)
    return RuleMetrics(
        support=support_rule,
        confidence=conf,
        lift=lift(conf, support_consequent),
    )


def compound_confidence(node_confidences: Sequence[float]) -> float:
    """Paper Eq. 1/4: Confidence of a rule whose consequent spans several
    consecutive trie nodes is the product of the per-node Confidences.

    ``node_confidences`` are the Confidence values of the consequent nodes
    in root-to-leaf order.
    """
    out = 1.0
    for c in node_confidences:
        out *= c
    return out


def compound_lift(
    compound_conf: float, support_full_consequent: float
) -> float:
    """Lift for a compound-consequent rule derived from the trie.

    Needs the Support of the *joint* consequent itemset, which the trie can
    answer via a root-anchored search of the consequent-as-prefix when the
    consequent is itself frequency-ordered; callers fall back to the miner's
    itemset table otherwise.
    """
    return lift(compound_conf, support_full_consequent)


def itemset_key(items: Iterable[Item]) -> ItemSet:
    return frozenset(items)


def is_close(a: float, b: float, tol: float = 1e-9) -> bool:
    return math.isclose(a, b, rel_tol=tol, abs_tol=tol)


@dataclass(frozen=True)
class Rule:
    """An association rule A -> C with metrics (the flat-table row)."""

    antecedent: Tuple[Item, ...]   # frequency-ordered, as mined
    consequent: Tuple[Item, ...]   # frequency-ordered continuation
    metrics: RuleMetrics

    @property
    def sequence(self) -> Tuple[Item, ...]:
        return self.antecedent + self.consequent

    def key(self) -> Tuple[Tuple[Item, ...], Tuple[Item, ...]]:
        return (self.antecedent, self.consequent)
