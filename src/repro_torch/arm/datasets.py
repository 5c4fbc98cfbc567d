"""Offline synthetic datasets with grocery/retail-like statistics.

The paper evaluates on (a) the R ``arules`` Groceries dataset — 9 834
transactions, 169 items, minsup 0.005 → ≈1 000 frequent sequences /
≈3 000 rules — and (b) the UCI Online Retail logs — ≈18 000 transactions,
3 600 items, minsup 0.002 → ≈45 000 sequences / ≈300 000 rules.  Neither ships
with this repository, so we generate transaction DBs with
matched first-order statistics: Zipfian item popularity plus latent
co-purchase profiles that induce genuine association structure (profiles →
frequent sequences with real lift).  The generator is seeded and fully
deterministic.  A copy of ``repro.arm.datasets``: the same seeds draw the
same transactions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .transactions import TransactionDB


@dataclass(frozen=True)
class SyntheticSpec:
    n_transactions: int
    n_items: int
    n_profiles: int          # latent co-purchase profiles
    profile_len_lo: int
    profile_len_hi: int
    p_profile_item: float    # P(include each item of an active profile)
    n_background_lo: int
    n_background_hi: int
    zipf_a: float            # Zipf exponent for background popularity
    seed: int


# Tuned so that minsup 0.005 yields ≈1 000 frequent sequences (the paper's
# Groceries operating point) and the average basket ≈4.6 items (vs 4.4).
GROCERY = SyntheticSpec(
    n_transactions=9834,
    n_items=169,
    n_profiles=24,
    profile_len_lo=3,
    profile_len_hi=7,
    p_profile_item=0.42,
    n_background_lo=1,
    n_background_hi=3,
    zipf_a=1.2,
    seed=20230901,
)

ONLINE_RETAIL = SyntheticSpec(
    n_transactions=18000,
    n_items=3600,
    n_profiles=160,
    profile_len_lo=4,
    profile_len_hi=10,
    p_profile_item=0.6,
    n_background_lo=2,
    n_background_hi=12,
    zipf_a=1.15,
    seed=20231002,
)


def _zipf_probs(n_items: int, a: float) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def synthesize(spec: SyntheticSpec) -> TransactionDB:
    rng = np.random.RandomState(spec.seed)
    probs = _zipf_probs(spec.n_items, spec.zipf_a)
    # Profiles prefer popular items (co-purchase structure among the head).
    profiles: List[np.ndarray] = []
    for _ in range(spec.n_profiles):
        length = rng.randint(spec.profile_len_lo, spec.profile_len_hi + 1)
        items = rng.choice(
            spec.n_items, size=length, replace=False, p=probs
        )
        profiles.append(items)
    profile_weights = rng.dirichlet(np.ones(spec.n_profiles) * 2.0)

    transactions: List[List[int]] = []
    for _ in range(spec.n_transactions):
        basket: set = set()
        n_active = 1 + (rng.rand() < 0.35)
        active = rng.choice(
            spec.n_profiles, size=n_active, replace=False, p=profile_weights
        )
        for pid in active:
            for it in profiles[pid]:
                if rng.rand() < spec.p_profile_item:
                    basket.add(int(it))
        n_bg = rng.randint(spec.n_background_lo, spec.n_background_hi + 1)
        for it in rng.choice(spec.n_items, size=n_bg, p=probs):
            basket.add(int(it))
        if not basket:
            basket.add(int(rng.choice(spec.n_items, p=probs)))
        transactions.append(sorted(basket))
    return TransactionDB(transactions, n_items=spec.n_items)


def grocery_db(seed: Optional[int] = None) -> TransactionDB:
    spec = GROCERY if seed is None else GROCERY.__class__(
        **{**GROCERY.__dict__, "seed": seed}
    )
    return synthesize(spec)


def online_retail_db(seed: Optional[int] = None) -> TransactionDB:
    spec = ONLINE_RETAIL if seed is None else ONLINE_RETAIL.__class__(
        **{**ONLINE_RETAIL.__dict__, "seed": seed}
    )
    return synthesize(spec)


def paper_example_db() -> TransactionDB:
    """The 5-transaction illustrative dataset of paper Fig. 4a.

    Items are letters mapped to ints: a..s → 0..18.
    """
    letter = {c: i for i, c in enumerate("abcdefghijklmnopqrs")}

    def tx(s: str) -> List[int]:
        return [letter[c] for c in s.replace(" ", "").split(",")]

    rows = [
        tx("f,a,c,d,g,i,m,p"),
        tx("a,b,c,f,l,m,o"),
        tx("b,f,h,j,o"),
        tx("b,c,k,s,p"),
        tx("a,f,c,e,l,p,m,n"),
    ]
    return TransactionDB(rows, n_items=19)
