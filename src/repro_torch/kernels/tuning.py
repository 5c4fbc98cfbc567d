"""The CUDA wrappers' launch knobs: the ``KernelConfig`` registry.

The wrappers' launch knobs (grid sizes, the fewest tiles a block takes,
the widest staged tile, the batched row pad) are *resolved at call time*
by ``get_kernel_config()``: the innermost ``tuning_overrides`` scope, else
``DEFAULTS``, the values picked by hand on one H100 while each kernel was
redesigned.  ``chip_smoke.py --tuning-only`` sweeps every knob on an H100
and prints each value's ms (``PERF.md``, "Tuning"); no value there beat
its default by more than the spread between two runs, so there is no
per-backend table as the reference has (``benchmarks/tuning/``), until a
card or configuration needs a value other than the default.  Overrides
are what tests and the sweep use to launch at other shapes.

Every knob is semantics-free by contract: the kernels' ids, ties and
int32 outputs are bitwise the plain versions' at ANY legal value.  The one
exception is the reduction's f32 sums: ``reduce_blocks_per_sm`` and
``reduce_single_block_tiles`` move the block count, which reassociates
them; they stay bitwise against ``ref.trie_reduce_split_ref`` at the same
block count and within 1e-6 relative of the default's, as the reference
allows for ``reduce_bn``.

Knobs (the reference knob whose role each takes, where there is one)
-----
``launch_pad_floor``
    Minimum row count batched launches pad to, after the next-pow2
    round-up (the reference's knob of the same name).  1 keeps pure pow2
    padding.
``select_work_blocks``
    Blocks a selection launch of the rank and membership kernels spreads
    its tiles over (``rank.selection_grid``), plus one a query at most.
    Takes ``rank_bn``'s role of sizing the work a block does.
``rank_min_tiles`` / ``member_min_tiles``
    The fewest DFS tiles a rank block (a membership block) takes
    (``plan_blocks``' ``min_tiles``, ``csrc/topk_select.cuh``).
``reduce_blocks_per_sm``
    Blocks of the reduction's persistent grid an SM, at most
    (``trie_reduce.launch_shape``).  Takes ``reduce_bn``'s role.
``reduce_single_block_tiles``
    The most tiles the reduction folds in one block, with no ticket.
``sweep_blocks_per_sm``
    Match blocks of the seed layout's sweep an SM
    (``rule_search.sweep_launch_shape``).  Its kernel keeps
    ``__launch_bounds__(SW_THREADS, 4)``: a grid of more blocks an SM than
    fit at once runs them in a later wave.
``support_max_bw``
    Words of the support count's staged tile, at most
    (``support_count.tile_words``): a power of two in 4..32, the widths
    the kernel is built for.

The reference's other knobs size TPU VMEM tiles and windows and have no
counterpart: ``rank_bn`` and ``reduce_bn`` (the CUDA kernels fix their
tiles at compile time; the grids above take their role), ``search_bf``
and ``span_bf`` (the descents read a bucket in rounds of 16-byte loads,
``ref.SEARCH_GROUP`` lanes a walk, whatever its width) and
``posting_window_edges`` (the membership kernel reads only each query's
members, never a resident posting array).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

# support_count.cu instantiates its staged tile at these widths
SUPPORT_BW = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    launch_pad_floor: int = 1
    select_work_blocks: int = 1024
    rank_min_tiles: int = 4
    member_min_tiles: int = 8
    reduce_blocks_per_sm: int = 4
    reduce_single_block_tiles: int = 2
    sweep_blocks_per_sm: int = 4
    support_max_bw: int = 32

    def validate(self) -> "KernelConfig":
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 1 or v & (v - 1):
                raise ValueError(
                    f"KernelConfig.{f.name} must be a power of two >= 1, "
                    f"got {v!r}"
                )
        if self.support_max_bw not in SUPPORT_BW:
            raise ValueError(
                f"KernelConfig.support_max_bw must be one of {SUPPORT_BW} "
                f"(the kernel's tile widths), got {self.support_max_bw}"
            )
        return self


DEFAULTS = KernelConfig()
KNOB_NAMES = tuple(f.name for f in dataclasses.fields(KernelConfig))

_active = DEFAULTS


def get_kernel_config() -> KernelConfig:
    """The active KernelConfig: the innermost ``tuning_overrides`` scope,
    else ``DEFAULTS``."""
    return _active


@contextlib.contextmanager
def tuning_overrides(**knobs) -> Iterator[KernelConfig]:
    """Scoped, process-wide knob overrides on top of the active config;
    they nest, and the previous config comes back on exit."""
    bad = set(knobs) - set(KNOB_NAMES)
    if bad:
        raise ValueError(
            f"unknown tuning knob(s) {sorted(bad)}; known: {KNOB_NAMES}"
        )
    global _active
    prev = _active
    _active = dataclasses.replace(prev, **knobs).validate()
    try:
        yield _active
    finally:
        _active = prev


def launch_pad(n: int) -> int:
    """Batched-launch row padding: the next power of two, floored at the
    active config's ``launch_pad_floor`` (1 by default: pure pow2)."""
    pow2 = 1 << max(int(n) - 1, 0).bit_length()
    return max(pow2, _active.launch_pad_floor)
