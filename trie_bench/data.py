"""The transaction database of a configuration, made from ``--seed``.

The configuration names its generator (``generator``).  ``synthesize``
is a frozen copy of the port's
``repro_torch.arm.datasets.synthesize`` (itself a copy of the JAX
package's): Zipfian item popularity plus latent co-purchase profiles, with
the first-order statistics of the dataset the configuration names.  Its
own seed is the configuration's (``spec.seed``), so every run serves a
database of one shape: the same number of frequent itemsets, the same
trie sizes, the same mining work.  ``--seed`` then relabels the items by
a random permutation and shuffles the transactions, so that each seed
hands the program and the reference a different database of that shape.
Support counts are invariant under both, so the ruleset a seed yields
has the same size on every seed; only which items sit where changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

SPEC_KEYS = (
    "n_transactions", "n_items", "n_profiles", "profile_len_lo",
    "profile_len_hi", "p_profile_item", "n_background_lo",
    "n_background_hi", "zipf_a", "spec_seed",
)


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


def spec_of(cfg: dict) -> SyntheticSpec:
    """The generator's spec from a configuration file's keys."""
    kw = {k: cfg[k] for k in SPEC_KEYS}
    kw["seed"] = kw.pop("spec_seed")
    return SyntheticSpec(**kw)


def _zipf_probs(n_items: int, a: float) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def synthesize(spec: SyntheticSpec) -> List[List[int]]:
    """The transactions, each a sorted list of item ids."""
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
    return transactions


GENERATORS = {"synthesize": lambda cfg: synthesize(spec_of(cfg))}


def make_transactions(cfg: dict, seed: int) -> List[List[int]]:
    """The configuration's database under ``seed``: the baskets of the
    generator it names (``cfg["generator"]``, a key of ``GENERATORS``) with
    their items relabeled by a seeded permutation and their order
    shuffled."""
    gen = cfg["generator"]
    if gen not in GENERATORS:
        raise ValueError(f"generator {gen!r} not in {sorted(GENERATORS)}")
    base = GENERATORS[gen](cfg)
    rng = np.random.default_rng(seed)
    relabel = rng.permutation(int(cfg["n_items"]))
    order = rng.permutation(len(base))
    return [sorted(int(relabel[it]) for it in base[i]) for i in order]
