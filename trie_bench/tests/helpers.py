"""A tiny copy of the benchmark for its CPU tests: the real harness, with a
``BENCHMARK.json`` whose one configuration is a database of a few hundred
baskets and whose mixes are the real ones with few clients."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "n_transactions": 600, "n_items": 80, "minsup": 0.02,
    "max_len": 12, "miner": "apriori", "layout": "plain",
    "generator": "synthesize", "n_profiles": 8, "profile_len_lo": 3,
    "profile_len_hi": 6, "p_profile_item": 0.6, "n_background_lo": 1,
    "n_background_hi": 4, "zipf_a": 1.15, "spec_seed": 7,
}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout holding the tiny benchmark: every
    mix of the real one as ``tiny.<mix>``, 16 clients each."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = tmp / "trie_bench" / "traffic"
    traffic.mkdir(parents=True)
    (tmp / "trie_bench" / "configs").mkdir()
    (tmp / "trie_bench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY))
    mixes = sorted({w["traffic"] for w in bench["workloads"]})
    for mix in mixes:
        m = json.loads((ROOT / "trie_bench" / "traffic"
                        / f"{mix}.json").read_text())
        m.update(clients=16, warmup_requests=64)
        if m.get("pool") is not None:
            m["pool"] = 64
        (traffic / f"{mix}.json").write_text(json.dumps(m))
    bench["configs"] = [{"name": "tiny", "source": "a test database",
                         "file": "trie_bench/configs/tiny.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"] = [{"name": f"tiny.{m}", "config": "tiny",
                           "traffic": m, "chips": 1, "why": "CPU tests"}
                          for m in mixes]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def python(code: str, timeout: float = 240) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter with the port and the benchmark
    importable: the run's check of loaded modules then sees only what the
    run loaded, not what other tests in this process imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def result_lines(stdout: str):
    """The JSON objects a run or a reading printed, one a line."""
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
