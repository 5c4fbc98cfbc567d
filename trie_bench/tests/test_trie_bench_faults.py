"""The comparison that decides ``correct`` has to fail its control and
every planted fault: ``readings.py`` at a tiny size on the CPU, with the
harness's look for a card skipped and the rest of each run driven as on
the card.  The control is the reference in the program's place in
bfloat16 (``control.py``); the faults break the timed path underneath
(``faults.py``)."""
from __future__ import annotations

import numpy as np
import pytest

from trie_bench import check, faults
from trie_bench.tests.helpers import python, result_lines, tiny_root

SEEDS = (11, 2**31 + 12, 2**33 + 13)

DRIVER = r"""
import sys
from trie_bench import readings
sys.exit(readings.main(["--workload", %(cell)r, "--seeds", *map(str, %(seeds)r),
                        "--seconds", "0.3", "--faults"],
                       device="cpu", root=%(root)r))
"""


@pytest.fixture(scope="module", params=["tiny.cold", "tiny.cold_wide"])
def readings(request, tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    p = python(DRIVER % {"cell": request.param, "seeds": SEEDS,
                         "root": str(root)})
    assert p.returncode == 0, p.stderr[-4000:]
    by = {}
    for r in result_lines(p.stdout):
        if "side" in r:
            by.setdefault(r["side"], []).append(r["numbers"])
    return by


def test_sound_runs_pass(readings):
    for nums in readings["program"]:
        assert check.judge(nums)[0], nums
    # float32 columns against float64: far inside the limits
    assert max(n["column_gap"] for n in readings["program"]) < 1e-6
    assert max(n["answer_gap"] for n in readings["program"]) < 1e-6


def test_the_bfloat16_control_fails(readings):
    ctl = readings["control"]
    assert len(ctl) == len(SEEDS)
    for nums in ctl:
        assert not check.judge(nums)[0], nums
        # each gap reads bfloat16's rounding, three times its limit or more
        assert nums["column_gap"] > 3 * check.LIMITS["column_gap"]
        assert nums["answer_gap"] > 3 * check.LIMITS["answer_gap"]


@pytest.mark.parametrize("fault", sorted(faults.ENGINE_FAULTS)
                         + sorted(faults.TRIE_FAULTS))
def test_every_fault_fails(readings, fault):
    got = readings[fault]
    assert len(got) == len(SEEDS)
    for nums in got:
        assert not check.judge(nums)[0], (fault, nums)


def test_half_batch_reads_as_wrong_answers(readings):
    assert min(n["answer_wrong"] for n in readings["half_batch"]) > 0


def test_the_control_answers_every_query(readings):
    assert all(n["unanswered"] == 0 for n in readings["control"])
    assert np.all([n["trie_mismatch"] == 0 for n in readings["control"]])
