"""Whole runs of the benchmark on the CPU at a tiny size: the last line's
schema, the compared numbers on standard error, the refusal without a
card, and the check of loaded modules.  Each run is made in a fresh
interpreter (``helpers.python``), so that the run's module check sees
only what the run loaded."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from trie_bench import check
from trie_bench.tests.helpers import ROOT, python, result_lines, tiny_root

DRIVER = r"""
import contextlib, io, json, sys, types
from trie_bench import run
out = {}
for cell in %(cells)r:
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = run.main(["--workload", cell, "--seed", str(2**31 + 77),
                       "--seconds", "0.3", "--trace", "0"],
                      device="cpu", root=%(root)r)
    out[cell] = {"rc": rc, "stdout": o.getvalue(), "stderr": e.getvalue()}
sys.modules["jax"] = types.ModuleType("jax")
o, e = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
    rc = run.main(["--workload", %(cells)r[0], "--seed", "5",
                   "--seconds", "0.2"], device="cpu", root=%(root)r)
out["with_jax"] = {"rc": rc, "stdout": o.getvalue(), "stderr": e.getvalue()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    p = python(DRIVER % {"cells": cells, "root": str(root)})
    assert p.returncode == 0, p.stderr[-4000:]
    return bench, json.loads(p.stdout.splitlines()[-1])


def test_every_mix_runs_correct_on_the_cpu(runs):
    bench, out = runs
    for w in bench["workloads"]:
        r = out[w["name"]]
        assert r["rc"] == 0, r["stderr"][-3000:]
        last = result_lines(r["stdout"])[-1]
        assert last["correct"] is True, r["stderr"][-3000:]
        assert last["failed"] == 0
        assert last["attempted"] > 0


def test_last_line_schema(runs):
    bench, out = runs
    for w in bench["workloads"]:
        r = out[w["name"]]
        line = r["stdout"].rstrip("\n").splitlines()[-1]
        last = json.loads(line)
        keys = list(last)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        # the compared numbers come last, each beside its limit
        assert keys[-1] == "checks"
        assert set(last["checks"]) == set(check.LIMITS)
        for name, c in last["checks"].items():
            assert c["limit"] == check.LIMITS[name]
            assert isinstance(c["value"], (int, float))
        want = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        assert {k: v["unit"] for k, v in last["metrics"].items()} == want
        for v in last["metrics"].values():
            assert isinstance(v["value"], float)
        dev = last["device"]
        assert set(dev) >= {"platform", "kind", "count",
                            "memory_peak_bytes"}
        assert dev["count"] == 1


def test_compared_numbers_are_the_last_lines_of_stderr(runs):
    _, out = runs
    for r in out.values():
        if r["rc"] != 0:
            continue
        tail = r["stderr"].rstrip("\n").splitlines()[-len(check.LIMITS):]
        assert [t.split()[1] for t in tail] == list(check.LIMITS)
        assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_a_loaded_jax_refuses_the_result(runs):
    _, out = runs
    r = out["with_jax"]
    assert r["rc"] != 0
    assert r["stdout"].strip() == ""
    assert "jax" in r["stderr"]


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing to
    standard output; on a machine with a card this is the next test's."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "trie_bench/run.py", "--workload",
         "retail_paper.cold", "--seed", "3", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compare_whole_names():
    from trie_bench import run

    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    saved = dict(sys.modules)
    try:
        for name in ("repro_torch_x", "jaxtyping", "reprox"):
            sys.modules.setdefault(name, type(sys)(name))
        found = run.forbidden_modules()
        assert not {"repro_torch_x", "jaxtyping", "reprox"} & set(found)
    finally:
        for name in ("repro_torch_x", "jaxtyping", "reprox"):
            if name not in saved:
                sys.modules.pop(name, None)
