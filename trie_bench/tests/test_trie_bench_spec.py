"""``BENCHMARK.json`` keeps to the benchmark's contract, the harness finds
a configuration, mix or metric by its name alone, and the reference loads
nothing of the program or of JAX."""
from __future__ import annotations

import json
import re
import shutil
from types import SimpleNamespace

import pytest

from trie_bench import spec
from trie_bench.tests.helpers import ROOT, python, result_lines, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word)
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not k.endswith(("_dim", "_rank"))
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert w["config"] in names
        assert (ROOT / "trie_bench" / "traffic"
                / f"{w['traffic']}.json").is_file()


def test_metrics():
    e2e = BENCH["end_to_end"]
    per = BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "trie_bench" / "metrics"
                / f"{m['name']}.py").is_file()
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        mine = [m["name"] for m in e2e if c in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in per)


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["n_items"] > 0
        assert cell["traffic"]["clients"] > 0
        assert [m["name"] for m in cell["end_to_end"]]
        for m in cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))


def test_added_files_are_found_without_editing(tmp_path):
    """A new configuration, mix and per-layer metric, each a file of its
    own and an entry in BENCHMARK.json, run with no harness file
    edited."""
    root = tiny_root(tmp_path)
    shutil.copytree(ROOT / "trie_bench" / "metrics",
                    root / "trie_bench" / "metrics")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "trie_bench" / "configs" / "tiny.json")
                     .read_text())
    cfg.update(name="tinier", n_transactions=400)
    (root / "trie_bench" / "configs" / "tinier.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "trie_bench" / "traffic" / "cold.json")
                     .read_text())
    mix.update(op_mix={"rule_search": 0.0, "top_k": 0.0, "rules_with": 1.0},
               k=3)
    (root / "trie_bench" / "traffic" / "only_rules_with.json").write_text(
        json.dumps(mix))
    (root / "trie_bench" / "metrics" / "launches_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx.loop.counters['launches'] / ctx.loop.window_s\n")
    bench["configs"].append({"name": "tinier", "source": "a test",
                             "file": "trie_bench/configs/tinier.json",
                             "reduced": ["n_transactions"], "why": "test"})
    bench["workloads"].append({"name": "tinier.only_rules_with",
                               "config": "tinier",
                               "traffic": "only_rules_with", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "launches_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "serve loop", "moves":
                               "queries_per_s",
                               "workloads": ["tinier.only_rules_with"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("tinier.only_rules_with", root)
    assert cell["config"]["n_transactions"] == 400
    assert cell["traffic"]["k"] == 3
    assert "launches_per_s" in [m["name"] for m in cell["per_layer"]]
    read = spec.metric_reader("launches_per_s", root)
    ctx = SimpleNamespace(loop=SimpleNamespace(counters={"launches": 50},
                                               window_s=2.0))
    assert read(ctx) == 25.0
    p = python(
        "import sys\nfrom trie_bench import run\n"
        "sys.exit(run.main(['--workload', 'tinier.only_rules_with', "
        f"'--seed', '4', '--seconds', '0.3'], device='cpu', root={str(root)!r}))")
    assert p.returncode == 0, p.stderr[-3000:]
    last = result_lines(p.stdout)[-1]
    assert last["correct"] is True
    assert last["attempted"] > 0


@pytest.mark.parametrize("key,value", [("generator", "quest"),
                                       ("miner", "fpmax"),
                                       ("layout", "compressed")])
def test_a_config_key_the_harness_does_not_know_is_refused(key, value):
    """The generator, miner and layout are read from the configuration; a
    value the harness cannot honour stops set-up before any build."""
    import torch

    from trie_bench import run
    from trie_bench.tests.helpers import TINY

    cfg = dict(TINY, **{key: value})
    mix = json.loads((ROOT / "trie_bench" / "traffic" / "cold.json")
                     .read_text())
    with pytest.raises(ValueError, match=value):
        run.setup({"config": cfg, "traffic": mix}, 1,
                  torch.device("cpu"), {})


def test_the_config_names_the_miner(tmp_path):
    """A configuration that names FP-growth is mined by FP-growth, and the
    reference still finds the run correct: both give every frequent
    itemset."""
    root = tiny_root(tmp_path)
    cfg_path = root / "trie_bench" / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg_path.write_text(json.dumps(dict(cfg, miner="fpgrowth")))
    p = python(
        "import sys\nfrom unittest import mock\nfrom trie_bench import run\n"
        "import repro_torch.core.builder as b\n"
        "seen = []\nreal = b.build_trie_of_rules\n"
        "def spy(*a, **k):\n    seen.append(k['miner'])\n"
        "    return real(*a, **k)\n"
        "with mock.patch.object(b, 'build_trie_of_rules', spy):\n"
        "    rc = run.main(['--workload', 'tiny.cold', '--seed', '8', "
        f"'--seconds', '0.2'], device='cpu', root={str(root)!r})\n"
        "print('MINERS', seen)\nsys.exit(rc)")
    assert p.returncode == 0, p.stderr[-3000:]
    assert "MINERS ['fpgrowth']" in p.stdout
    assert result_lines(p.stdout)[-1]["correct"] is True


def test_reference_loads_nothing_of_the_program_or_jax():
    p = python(
        "import sys, json\n"
        "from trie_bench import check, control, data, loadgen, roofline\n"
        "from trie_bench.reference import answers, mine\n"
        "tx = data.make_transactions({'generator': 'synthesize',"
        " 'n_transactions': 200, 'n_items': 30,"
        " 'n_profiles': 4, 'profile_len_lo': 3, 'profile_len_hi': 5,"
        " 'p_profile_item': 0.6, 'n_background_lo': 1, 'n_background_hi': 3,"
        " 'zipf_a': 1.15, 'spec_seed': 3}, 1)\n"
        "ref = mine.mine(tx, 30, 0.05, 12)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(tops & {'repro_torch', 'repro', 'jax',"
        " 'jaxlib', 'flax'})))\n")
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "trie_bench").rglob("*.py")))
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    src = (ROOT / path).read_text()
    banned = {"jax", "jaxlib", "flax", "repro"}
    if "/reference/" in path:
        banned.add("repro_torch")
    for m in re.finditer(r"^\s*(?:from|import)\s+([A-Za-z_]\w*)", src,
                         re.M):
        assert m.group(1) not in banned, path

