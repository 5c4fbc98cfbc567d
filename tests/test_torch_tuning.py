"""The port's launch-knob registry against the reference's contract:
``KernelConfig`` validation, resolution (a scoped ``tuning_overrides``
over the defaults; no table, and neither the reference's table directory
nor its overrides reach the port), ``launch_pad``'s floor, and
``interpret_mode`` under ``REPRO_TORCH_FORCE_INTERPRET`` (the reference's
``tests/test_tuning.py`` cases, run on the port); each wrapper's launch
shape following its knob, pinned as literals under the defaults (the
constants the knobs replace); and the serve loop bitwise the reference's
at launch-pad floors 1 and 2, each package under its own override of the
floor.

Tolerance: bitwise everywhere (the reduction's sums within 1e-6 relative
of the plain version at any block count, as the reference allows for
``reduce_bn``)."""
import dataclasses
import importlib
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as J  # noqa: E402
from repro.core import synthetic as JSyn  # noqa: E402
from repro.kernels.tuning import tuning_overrides as j_overrides  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro_torch.core import synthetic as TSyn  # noqa: E402
from repro_torch.kernels import _build, item_index, rank, ref  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.tuning import (  # noqa: E402
    DEFAULTS,
    KNOB_NAMES,
    KernelConfig,
    get_kernel_config,
    launch_pad,
    tuning_overrides,
)

# the package re-exports ops of these names: the modules themselves
rule_search, support_count, trie_reduce = (
    importlib.import_module(f"repro_torch.kernels.{m}")
    for m in ("rule_search", "support_count", "trie_reduce"))


@pytest.fixture
def at_defaults():
    """No override is active: every knob resolves to its default."""
    assert get_kernel_config() is DEFAULTS
    yield
    assert get_kernel_config() is DEFAULTS


# ----------------------------------------------------------------------
# KernelConfig
# ----------------------------------------------------------------------
def test_defaults_are_the_constants_they_replace():
    assert DEFAULTS == KernelConfig(
        launch_pad_floor=1, select_work_blocks=1024, rank_min_tiles=4,
        member_min_tiles=8, reduce_blocks_per_sm=4,
        reduce_single_block_tiles=2, sweep_blocks_per_sm=4,
        support_max_bw=32)
    assert (rank.WORK_BLOCKS, rank.MIN_TILES, item_index.MIN_TILES) == \
        (1024, 4, 8)
    DEFAULTS.validate()


@pytest.mark.parametrize("knob", KNOB_NAMES)
@pytest.mark.parametrize("bad", [0, -1, 3, 6, 2.0, "4"])
def test_knobs_must_be_powers_of_two(knob, bad):
    with pytest.raises(ValueError):
        dataclasses.replace(DEFAULTS, **{knob: bad}).validate()


@pytest.mark.parametrize("bad", [1, 2, 64])
def test_support_max_bw_is_a_kernel_width(bad):
    with pytest.raises(ValueError, match="support_max_bw"):
        dataclasses.replace(DEFAULTS, support_max_bw=bad).validate()


def test_knob_names_cover_all_fields():
    assert set(KNOB_NAMES) == {
        f.name for f in dataclasses.fields(KernelConfig)}


# ----------------------------------------------------------------------
# resolution: an override, else the defaults
# ----------------------------------------------------------------------
def test_no_override_resolves_the_defaults(at_defaults):
    assert get_kernel_config() == DEFAULTS
    assert launch_pad(3) == 4


def test_reference_tables_and_overrides_do_not_reach_the_port(
        at_defaults, monkeypatch, tmp_path):
    # the reference's override first, under its own committed table: with
    # the directory below set, the reference would cache that table for
    # every later test in this process
    with j_overrides(launch_pad_floor=16):
        assert launch_pad(3) == 4
        assert get_kernel_config() == DEFAULTS
    with open(tmp_path / "cpu.json", "w") as fh:
        json.dump({"knobs": {"launch_pad_floor": 16}}, fh)
    monkeypatch.setenv("REPRO_TUNING_DIR", str(tmp_path))
    assert get_kernel_config() == DEFAULTS
    assert launch_pad(3) == 4


# ----------------------------------------------------------------------
# tuning_overrides and launch_pad
# ----------------------------------------------------------------------
def test_scoped_override_and_restore(at_defaults):
    before = get_kernel_config()
    with tuning_overrides(sweep_blocks_per_sm=8) as cfg:
        assert cfg.sweep_blocks_per_sm == 8
        assert get_kernel_config().sweep_blocks_per_sm == 8
    assert get_kernel_config() == before


def test_unknown_knob_rejected(at_defaults):
    with pytest.raises(ValueError, match="unknown tuning knob"):
        with tuning_overrides(rank_bn=4096):
            pass  # pragma: no cover
    with pytest.raises(ValueError):
        with tuning_overrides(support_max_bw=64):
            pass  # pragma: no cover


def test_nested_overrides_compose(at_defaults):
    with tuning_overrides(select_work_blocks=256):
        with tuning_overrides(rank_min_tiles=1) as inner:
            assert inner.select_work_blocks == 256
            assert inner.rank_min_tiles == 1
        assert get_kernel_config().rank_min_tiles == DEFAULTS.rank_min_tiles
        assert get_kernel_config().select_work_blocks == 256
    assert get_kernel_config() == DEFAULTS


def test_launch_pad_pure_pow2_at_default_floor(at_defaults):
    assert [launch_pad(n) for n in (0, 1, 2, 3, 5, 8, 9)] == \
        [1, 1, 2, 4, 8, 8, 16]


def test_launch_pad_floor_applies_below_only(at_defaults):
    with tuning_overrides(launch_pad_floor=8):
        assert launch_pad(1) == 8 and launch_pad(3) == 8
        assert launch_pad(9) == 16
        # the ops' row padding follows it
        q = np.array([[1, 2], [3, -1], [1, 2]], np.int32)
        uq, ual, inv = TO.dedup_query_rows(q, np.array([1, 1, 1], np.int32))
        assert uq.shape == (8, 2) and inv.tolist() == [0, 1, 0]
        rows = TO._pad_pow2_rows(np.zeros(3, np.int32),
                                 np.zeros(3, np.int32),
                                 np.arange(3, dtype=np.int32))
        assert [r.shape for r in rows] == [(8,)] * 3
        assert rows[2].tolist() == [0, 1, 2] + [-1] * 5


# ----------------------------------------------------------------------
# each wrapper's launch shape follows its knob
# ----------------------------------------------------------------------
def test_rank_and_member_launch_shapes(at_defaults):
    assert rank.selection_grid(256, 100) == (1024, 1280)
    s = rank.launch_shape(256, 100, 1 << 20)
    assert (s["work_blocks"], s["grid"], s["min_tiles"], s["list_cap"]) == \
        (1024, 1280, 4, 102)
    assert item_index.launch_shape(256, 10) == {
        "work_blocks": 1024, "grid": 1280, "min_tiles": 8,
        "plan_words": 3 * 256 + 1280}
    with tuning_overrides(select_work_blocks=256, rank_min_tiles=16,
                          member_min_tiles=2):
        s = rank.launch_shape(256, 100, 1 << 20)
        assert (s["work_blocks"], s["grid"], s["min_tiles"]) == \
            (256, 512, 16)
        assert s["words"] >= 256 * s["list_cap"] + s["grid"]
        assert item_index.launch_shape(256, 10) == {
            "work_blocks": 256, "grid": 512, "min_tiles": 2,
            "plan_words": 3 * 256 + 512}
    # past LIST_ELEMS // k - q the lists' room, not the knob, sizes the grid
    with tuning_overrides(select_work_blocks=4096):
        assert rank.selection_grid(256, 1500) == (2540, 2796)
        assert rank.selection_grid(256, 100) == (4096, 4352)


def test_reduce_launch_shape(at_defaults):
    assert trie_reduce.launch_shape(1_048_577, 4, 0, 132)["blocks"] == 256
    assert trie_reduce.launch_shape(8_388_609, 4, 0, 132)["blocks"] == 528
    assert trie_reduce.launch_shape(2 * 4096, 4, 0, 132)["blocks"] == 1
    assert trie_reduce.launch_shape(4 * 4096, 4, 0, 132)["blocks"] == 4
    with tuning_overrides(reduce_blocks_per_sm=1):
        assert trie_reduce.launch_shape(1_048_577, 4, 0, 132)["blocks"] == 132
    with tuning_overrides(reduce_blocks_per_sm=8):
        assert trie_reduce.launch_shape(8_388_609, 4, 0, 132)["blocks"] == \
            1056
    with tuning_overrides(reduce_single_block_tiles=8):
        assert trie_reduce.launch_shape(8 * 4096, 4, 0, 132)["blocks"] == 1
        assert trie_reduce.launch_shape(9 * 4096, 4, 0, 132)["blocks"] == 9
    with tuning_overrides(reduce_single_block_tiles=1):
        assert trie_reduce.launch_shape(2 * 4096, 4, 0, 132)["blocks"] == 2
        # no tile at all: still one block (head and tail)
        assert trie_reduce.launch_shape(3, 16, 0, 132)["blocks"] == 1


def test_reduce_scratch_grows_with_the_grid():
    """The ticket-and-partials buffer is cached per (device, stream) and
    replaced by a larger zeroed one when a grid outgrows it."""
    dev = torch.device("cpu")
    trie_reduce._scratch.pop((None, 12345), None)
    small = trie_reduce._scratch_for(dev, 12345, 4)
    assert small.numel() * 4 == 16 * 5 and not small.any()
    assert trie_reduce._scratch_for(dev, 12345, 2) is small
    big = trie_reduce._scratch_for(dev, 12345, 1056)
    assert big.numel() * 4 == 16 * 1057 and not big.any()
    assert trie_reduce._scratch_for(dev, 12345, 528) is big
    trie_reduce._scratch.pop((None, 12345))


@pytest.mark.parametrize("knobs", [{}, dict(reduce_blocks_per_sm=1),
                                   dict(reduce_blocks_per_sm=8),
                                   dict(reduce_single_block_tiles=8)])
def test_reduce_mirror_at_the_knobs_block_count(at_defaults, knobs):
    """``ref.trie_reduce_split_ref`` at the block count a knob gives: count
    and max bitwise the plain version, the sums within 1e-6 relative."""
    rng = np.random.RandomState(3)
    n = 9 * 4096 + 7
    cols = (torch.from_numpy(rng.rand(n).astype(np.float32)),
            torch.from_numpy(rng.rand(n).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)))
    want = ref.trie_reduce_ref(*cols)
    with tuning_overrides(**knobs):
        shape = trie_reduce.launch_shape(n, 4, 0, 2)
        got = ref.trie_reduce_split_ref(*cols, blocks=shape["blocks"],
                                        threads=shape["threads"],
                                        unroll=shape["unroll"])
    assert shape["blocks"] == {(): 8, ("reduce_blocks_per_sm", 1): 2,
                               ("reduce_blocks_per_sm", 8): 10,
                               ("reduce_single_block_tiles", 8): 8}[
        tuple(*knobs.items())]
    for i in (0, 2):
        assert got[i].view(torch.int32) == want[i].view(torch.int32)
    for i in (1, 3):
        assert abs(float(got[i]) - float(want[i])) <= 1e-6 * float(want[i])


def test_sweep_launch_shape(at_defaults):
    assert rule_search.sweep_launch_shape(8192, 8, 1 << 20, 132)[
        "match_blocks"] == 528
    for per_sm, blocks in ((1, 132), (2, 264), (8, 1056)):
        with tuning_overrides(sweep_blocks_per_sm=per_sm):
            s = rule_search.sweep_launch_shape(8192, 8, 1 << 20, 132)
            assert (s["match_blocks"], s["warps"]) == (blocks, 8 * blocks)
            # a tiny call's units, not the knob, size its grid
            assert rule_search.sweep_launch_shape(33, 5, 300, 132)[
                "match_blocks"] == 1


def test_support_tile_words(at_defaults):
    assert support_count.tile_words(462, 563, 3600) == 32
    assert support_count.launch_shape(462, 563, 3600, 106_491, 132)[
        "tiles"] == 18
    for bw in (4, 8, 16):
        with tuning_overrides(support_max_bw=bw):
            assert support_count.tile_words(462, 563, 3600) == bw
            s = support_count.launch_shape(462, 563, 3600, 106_491, 132)
            assert (s["bw"], s["tiles"]) == (bw, -(-563 // bw))
            # a narrow DB's own cover still caps it
            assert support_count.tile_words(462, 5, 3600) == min(8, bw)


# ----------------------------------------------------------------------
# interpret_mode (the reference's TestInterpretMode, on the port's
# variable and devices)
# ----------------------------------------------------------------------
@pytest.fixture
def fresh_mode(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FORCE_INTERPRET", raising=False)
    _build._interpret_cache.clear()
    yield
    _build._interpret_cache.clear()


def test_default_plain_on_cpu_kernel_on_cuda(fresh_mode):
    assert TO.interpret_mode is _build.interpret_mode
    assert TO.interpret_mode("cpu") is True
    assert TO.interpret_mode(torch.device("cpu")) is True
    assert TO.interpret_mode() is True          # no CUDA on this host
    assert TO.interpret_mode("cuda") is False
    assert TO.interpret_mode(torch.device("cuda", 1)) is False


@pytest.mark.parametrize("val,mode", [
    ("1", True), ("true", True), ("interpret", True), ("ON", True),
    ("0", False), ("false", False), ("compiled", False), ("Off", False),
])
def test_env_override(fresh_mode, monkeypatch, val, mode):
    """The variable can only assert what the device decides: the plain
    versions on the CPU, the kernels on CUDA; the other device raises
    (never a kernel's plain version on the card, never a quiet plain
    version where kernels were asked for)."""
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", val)
    ok, other = ("cpu", "cuda") if mode else ("cuda", "cpu")
    assert TO.interpret_mode(ok) is mode
    with pytest.raises(ValueError, match="REPRO_TORCH_FORCE_INTERPRET"):
        TO.interpret_mode(other)


def test_unrecognized_value_raises(fresh_mode, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "maybe")
    with pytest.raises(ValueError, match="not understood"):
        TO.interpret_mode("cuda")


def test_flip_mid_process_takes_effect(fresh_mode, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "1")
    assert TO.interpret_mode("cpu") is True
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "0")
    assert TO.interpret_mode("cuda") is False
    with pytest.raises(ValueError):
        TO.interpret_mode("cpu")
    assert ("1", "cpu") in _build._interpret_cache
    assert ("0", "cuda") in _build._interpret_cache
    assert ("0", "cpu") not in _build._interpret_cache


def test_reference_interpret_variable_does_not_reach_the_port(fresh_mode,
                                                              monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "0")
    assert TO.interpret_mode("cpu") is True


def test_wrappers_go_through_interpret_mode(fresh_mode, monkeypatch):
    """On CPU tensors the wrappers run their plain versions; forcing the
    kernels there makes them raise instead."""
    fz = TSyn.frozen_from_arrays(TSyn.synthetic_csr_trie(1 << 8, seed=0))
    t = TO.dfs_rank_arrays(fz, device="cpu")
    los, his, _ = TO.prefix_ranges(fz, [[], [1]], device="cpu")
    args = (t["support"], t["confidence"], t["lift"], t["depth"], los, his)
    dt = fz.device_arrays(device="cpu")
    red = (dt.support, dt.confidence, dt.node_depth)
    before = rank.topk_rank_batch.launches
    got = rank.topk_rank_batch(*args, k=5)
    assert rank.topk_rank_batch.launches == before
    want = ref.topk_rank_batch_ref(*args, k=5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    trie_reduce.trie_reduce_columns(*red)
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "0")
    with pytest.raises(ValueError, match="REPRO_TORCH_FORCE_INTERPRET"):
        rank.topk_rank_batch(*args, k=5)
    with pytest.raises(ValueError, match="REPRO_TORCH_FORCE_INTERPRET"):
        trie_reduce.trie_reduce_columns(*red)


# ----------------------------------------------------------------------
# the serve loop bitwise the reference's at launch-pad floors 1 and 2
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rnd():
    """A random 300-node CSR trie, from each package's generator."""
    ja = JSyn.random_csr_trie(np.random.RandomState(7), 300, 12)
    ta = TSyn.random_csr_trie(np.random.RandomState(7), 300, 12)
    return JSyn.frozen_from_arrays(ja), TSyn.frozen_from_arrays(ta)


def _floor_replay(S, fz):
    """A Poisson-arrival zipfian workload with deadlines through package
    ``S``'s scheduler on a virtual clock charged 2 ms a launch (a slow
    shard): the shaper's deadline decisions read the launch predictor,
    whose buckets are keyed by ``launch_pad``."""
    clock = S.VirtualClock()
    kw = {"device": "cpu"} if S is T else {}
    eng = S.FaultyEngine(S.TrieQueryEngine(fz, mode="replicated", **kw),
                         S.FaultInjector().slow_shard(0, 0.002), clock=clock)
    sched = S.TrieScheduler(eng, clock=clock, max_batch=8, max_pending=64)
    # the ranking ops only: the reference's search adds ~9 s of
    # interpret-mode compiles and nothing the floor reaches differently
    wl = [w for w in S.zipfian_workload(fz, 64, seed=11,
                                        arrival_rate=3000.0,
                                        deadline_ms=(3.0, 9.0, math.inf))
          if w["op"] != "rule_search"]
    out, i = [], 0
    while i < len(wl) or sched.pending:
        while i < len(wl) and wl[i]["arrival_s"] <= clock.now() + 1e-12:
            w = wl[i]
            i += 1
            sched.submit(w["op"], w["payload"], w["kwargs"],
                         deadline_ms=w["deadline_ms"], tenant=w["tenant"])
        if sched.pending:
            out.extend(sched.step())
        elif i < len(wl):
            clock.sleep(wl[i]["arrival_s"] - clock.now())
    return out, sched


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("floor", [1, 2])
def test_serve_loop_matches_reference_at_floor(rnd, floor, at_defaults):
    jf, tf = rnd
    with j_overrides(launch_pad_floor=floor):
        want, jsched = _floor_replay(J, jf)
    with tuning_overrides(launch_pad_floor=floor):
        got, tsched = _floor_replay(T, tf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("id", "op", "status", "cache_hit", "latency_ms"):
            assert getattr(g, f) == getattr(w, f), (f, g, w)
        assert (g.result is None) == (w.result is None)
        if w.result is not None:
            assert set(g.result) == set(w.result)
            for key in w.result:
                a, b = _host(g.result[key]), _host(w.result[key])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tsched.stats == jsched.stats
    assert tsched.stats["ok"] and tsched.stats["timeout"]
    buckets = tsched.predictor._ewma_ms
    assert buckets == jsched.predictor._ewma_ms
    assert min(k[-1] for k in buckets) == floor
