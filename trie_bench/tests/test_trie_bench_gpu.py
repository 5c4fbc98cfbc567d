"""Short runs of the benchmark's real cells on the card: a run and a
traced run of each mix on the paper's ruleset come out correct and carry
the result line's keys.  Marked ``gpu``; each test skips without a CUDA
device.

    PYTHONPATH=src python -m pytest -q -m gpu trie_bench/tests
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from trie_bench.tests.helpers import ROOT

pytestmark = pytest.mark.gpu


def needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run(cell, seed, trace):
    p = subprocess.run(
        [sys.executable, "trie_bench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.splitlines()[-1])


@pytest.mark.parametrize("cell", ["retail_paper.cold", "retail_paper.cold_wide",
                                  "retail_paper.hot"])
def test_cell_runs_correct_on_the_card(cell):
    needs_card()
    out = run(cell, 2**31 + 101, 0)
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"queries_per_s", "setup_s"}
    traced = run(cell, 2**31 + 102, 1)
    assert traced["correct"] is True
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert {"cache_hit_pct", "device_idle_pct", "engine_call_ms",
            "response_p95_ms"} <= set(traced["metrics"])
    for name, m in traced["metrics"].items():
        if "roofline" in name:
            assert 0 < m["value"] <= 100
    assert len(traced["breakdown"]["device_ops"]) <= 10
