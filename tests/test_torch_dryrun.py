"""The port's dry run: ``launch/specs.py`` against the reference's layout,
``launch/dryrun.py``'s counts against real CPU steps and hand-worked
literals, ``_poly_extrapolate`` against direct counts, the roofline's
model half and ``launch/perf.py``'s variants against the reference's,
``make_production_mesh``, and the modules importing with JAX and the
reference blocked.

Forwards run at reduced widths only; the full configs are laid out
(specs), never run, except smollm-360m's decode_32k cell on meta tensors
(its pinned count).  Counts are integers and compared exactly; the
extrapolation within 1e-12 relative.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import perf as ref_perf  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    get_config,
    get_reduced_config,
    get_shape,
)
from repro_torch.configs.base import (  # noqa: E402
    LayerSpec,
    MoEConfig,
    ShapeConfig,
)
from repro_torch.distributed.sharding import get_mesh, use_mesh  # noqa: E402
from repro_torch.launch import dryrun, perf, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    AbstractMesh,
    make_production_mesh,
)
from repro_torch.models import init_cache, materialize_params  # noqa: E402
from repro_torch.pytree import tree_leaves_with_path  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
)
from repro_torch.train.optimizer import pick_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
ONE = AbstractMesh((1, 1), ("data", "model"))
TWO = AbstractMesh((2, 2), ("data", "model"))


def _ref_path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _ref_layout(tree):
    """{path: (spec, local shape, local bytes)} of a reference SDS tree."""
    out = {}
    for path, sds in jax.tree_util.tree_leaves_with_path(tree):
        local = tuple(sds.sharding.shard_shape(sds.shape))
        n = 1
        for x in local:
            n *= x
        out[_ref_path(path)] = (tuple(sds.sharding.spec), local,
                                n * sds.dtype.itemsize)
    return out


def _port_layout(tree):
    return {path: (leaf.spec, leaf.local_shape, leaf.local_nbytes)
            for path, leaf in tree_leaves_with_path(tree)}


# ----------------------------------------------------------------------
# specs against the reference, exactly
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    shape = get_shape("decode_32k")
    for multi_pod, (sizes, names) in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi_pod)
        jmesh = JaxAbstractMesh(sizes, names)
        got = _port_layout(specs.param_specs(cfg, mesh)[0])
        want = _ref_layout(ref_specs.param_specs(ref_cfg, jmesh)[0])
        assert got == want, (arch, multi_pod)
        assert specs.tree_nbytes(specs.param_specs(cfg, mesh)[0]) == sum(
            v[2] for v in want.values())
        got = _port_layout(specs.cache_specs(
            cfg, mesh, shape.global_batch, shape.seq_len))
        want = _ref_layout(ref_specs.cache_specs(
            ref_cfg, jmesh, shape.global_batch, shape.seq_len))
        assert got == want, (arch, multi_pod)


@pytest.mark.parametrize("arch", ["pixtral-12b", "deepseek-v3-671b"])
def test_input_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    mesh = make_production_mesh()
    jmesh = JaxAbstractMesh(*MESHES[False])
    for shape in SHAPES:
        got = specs.input_specs(cfg, shape, mesh)
        want = ref_specs.input_specs(ref_cfg, shape, jmesh)
        assert _port_layout(got) == _ref_layout(want), shape.name


def test_serving_rules_follow_the_reference():
    mesh = make_production_mesh()
    jmesh = JaxAbstractMesh(*MESHES[False])
    for tp in (True, False):
        cfg = get_config("deepseek-v2-lite-16b").scaled(
            serving=True, serve_expert_ff_tp=tp)
        ref_cfg = ref_configs.get_config("deepseek-v2-lite-16b").scaled(
            serving=True, serve_expert_ff_tp=tp)
        assert _port_layout(specs.param_specs(cfg, mesh)[0]) == \
            _ref_layout(ref_specs.param_specs(ref_cfg, jmesh)[0])


# ----------------------------------------------------------------------
# FLOPs on a 1 x 1 mesh: the real CPU step, exactly
# ----------------------------------------------------------------------
def _moe_alltoall(cfg):
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, impl="alltoall"))


def _cpu_step_flops(cfg, shape):
    """FlopCounterMode around the real step on CPU tensors."""
    gen = torch.Generator().manual_seed(0)
    params, _ = materialize_params(cfg, gen, "cpu")
    b, s = shape.global_batch, shape.seq_len
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        dtype=torch.int32)
    with use_mesh(ONE):
        if shape.kind == "train":
            opt = pick_optimizer(cfg)
            state = opt.init(params)
            batch = {"tokens": tok, "labels": tok}
            if cfg.frontend != "none":
                batch["frontend_embeds"] = torch.randn(
                    (b, cfg.frontend_len, cfg.d_model), generator=gen
                ).to(torch.bfloat16)
            with FlopCounterMode(display=False) as fc:
                make_train_step(cfg, opt)(params, state, batch, 0.0)
        elif shape.kind == "prefill":
            cache = init_cache(cfg, b, s, device="cpu")
            with FlopCounterMode(display=False) as fc:
                make_prefill_step(cfg)(params, cache, {"tokens": tok})
        else:
            cache = init_cache(cfg, b, s, device="cpu")
            with FlopCounterMode(display=False) as fc:
                make_decode_step(cfg)(params, cache, tok[:, :1])
    return fc.get_total_flops()


CELLS_1X1 = [
    ("smollm-360m", ShapeConfig("t", 256, 2, "train")),
    ("smollm-360m", ShapeConfig("p", 512, 2, "prefill")),
    ("smollm-360m", ShapeConfig("d", 96, 2, "decode")),
    ("deepseek-v3-671b", ShapeConfig("t", 256, 2, "train")),
    ("deepseek-v3-671b", ShapeConfig("d", 96, 2, "decode")),
    ("musicgen-large", ShapeConfig("t", 512, 2, "train")),
]


@pytest.mark.parametrize("arch,shape", CELLS_1X1,
                         ids=[f"{a}-{s.kind}" for a, s in CELLS_1X1])
def test_flops_on_one_device_equal_the_real_step(arch, shape):
    cfg = get_reduced_config(arch).scaled(remat=True)
    if cfg.moe is not None:
        cfg = _moe_alltoall(cfg)
    rec = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                          mesh=ONE)
    assert rec["mesh"] == "mesh1x1" and rec["n_devices"] == 1
    assert isinstance(rec["flops_per_device"], int)
    assert rec["flops_per_device"] == _cpu_step_flops(cfg, shape)
    coll = rec["collective_bytes_per_device"]
    assert set(coll) == set(dryrun._MULT) | {"total"}
    assert all(v == 0 for v in coll.values())
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] == 0
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]


def test_record_has_the_reference_keys():
    shape = ShapeConfig("d", 96, 2, "decode")
    rec = dryrun.run_cell("smollm-360m", "d", False,
                          cfg=get_reduced_config("smollm-360m"),
                          shape=shape, mesh=ONE)
    assert set(rec) == {
        "arch", "shape", "mesh", "kind", "n_devices", "lower_seconds",
        "compile_seconds", "cost_measure_seconds", "memory",
        "flops_per_device", "bytes_per_device",
        "bytes_boundary_per_device", "collective_bytes_per_device",
        "raw_measurements"}
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes"}
    # decode: params + cache + tokens; the cache donated
    cfg = get_reduced_config("smollm-360m")
    p = specs.param_specs(cfg, ONE)[0]
    c = specs.cache_specs(cfg, ONE, 2, 96)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == (
        specs.tree_nbytes(p) + specs.tree_nbytes(c) + 2 * 4)
    assert mem["alias_size_in_bytes"] == specs.tree_nbytes(c)
    # logits [2, 1, 128] f32 and the cache come back
    assert mem["output_size_in_bytes"] == 2 * 128 * 4 + specs.tree_nbytes(c)
    assert rec["bytes_boundary_per_device"] >= \
        mem["argument_size_in_bytes"]
    assert rec["bytes_per_device"] > rec["flops_per_device"] / 64


# ----------------------------------------------------------------------
# the extrapolation against direct counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_poly_extrapolate_equals_a_direct_count(kind):
    cfg = get_reduced_config("minitron-8b").scaled(remat=True)
    shape = ShapeConfig("x", 6 * dryrun.Q_CHUNK, 4, kind)
    opt = pick_optimizer(cfg) if kind == "train" else None
    meas = {(u, c): dryrun._costs(dryrun.Program(
        cfg.scaled(n_units=u), shape, TWO, seq=c * dryrun.Q_CHUNK,
        optimizer=opt)) for u in (1, 2) for c in (2, 3, 4)}
    fit = dryrun._poly_extrapolate(meas, 3, 6, quadratic=kind == "train")
    direct = dryrun._costs(dryrun.Program(cfg.scaled(n_units=3), shape, TWO,
                                          optimizer=opt))
    for k in ("flops", "bytes", "bytes_boundary"):
        assert fit[k] == pytest.approx(direct[k], rel=1e-12, abs=0), k
    for k, v in direct["collectives"].items():
        assert fit["collectives"][k] == pytest.approx(v, rel=1e-12,
                                                      abs=0), k
    assert direct["collectives"]["total"] > 0


def test_poly_extrapolate_is_exact_on_integer_polynomials():
    def cost(u, c):
        return {"flops": 7 + 3 * u + 5 * c + 11 * u * c + 2 * c * c
                + 13 * u * c * c, "bytes": 1, "bytes_boundary": 0,
                "collectives": {"all-reduce": 4 * u * c}}

    meas = {(u, c): cost(u, c) for u in (1, 2) for c in (2, 3, 4)}
    fit = dryrun._poly_extrapolate(meas, 61, 16)
    assert fit["flops"] == cost(61, 16)["flops"]
    assert isinstance(fit["flops"], int)
    assert fit["collectives"]["all-reduce"] == 4 * 61 * 16
    fit = dryrun._poly_extrapolate(meas, 61, 16, quadratic=False)
    assert fit["bytes"] == 1


# ----------------------------------------------------------------------
# a 2 x 2 mesh, every split dim dividing
# ----------------------------------------------------------------------
def _moe_cfg():
    """reduced minitron (4 q / 2 kv heads of 16, d_model 64, d_ff 128,
    vocab 256) with its units (attention, MoE): 4 experts top-2 of 32 and
    one shared expert."""
    return get_reduced_config("minitron-8b").scaled(
        unit=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_routed=4, n_shared=1, top_k=2, d_expert=32,
                      impl="alltoall"))


PREFILL = ShapeConfig("p", 512, 4, "prefill")


def test_two_by_two_splits_the_dense_work_four_ways():
    cfg = _moe_cfg()
    one = dryrun.run_cell("moe", "p", False, cfg=cfg, shape=PREFILL,
                          mesh=ONE)["flops_per_device"]
    two = dryrun.run_cell("moe", "p", False, cfg=cfg, shape=PREFILL,
                          mesh=TWO)["flops_per_device"]
    # per MoE layer a forward: the router over all 4 experts, 2·T·64·4,
    # and the routed experts, e_local · cap · 6 · 64 · 32 with cap =
    # _capacity(T) = ceil8(int(T · 2 · 1.25 / 4)):
    #   1 x 1: T = 4 · 512 = 2048, cap 1280, e_local 4
    #          router 1,048,576, routed 4 · 1280 · 12,288 = 62,914,560
    #   2 x 2: T = 2 · 512 = 1024, cap 640, e_local 2
    #          router 524,288, routed 2 · 640 · 12,288 = 15,728,640
    units = cfg.n_units
    dense_one = one - units * (1_048_576 + 62_914_560)
    dense_two = two - units * (524_288 + 15_728_640)
    assert dense_two * 4 == dense_one
    assert units * 15_728_640 < dense_two / 4


def test_two_by_two_one_units_collectives_by_hand():
    cfg = _moe_cfg()
    got = [dryrun.collective_bytes(dryrun.Program(
        cfg.scaled(n_units=u), PREFILL, TWO)) for u in (1, 2)]
    unit = {k: got[1][k] - got[0][k] for k in got[0]}
    # FSDP all-gathers (d_model split over data; f32), one unit's leaves
    # at compute shape: wq [64, 2, 16] and wo [2, 16, 64] 8,192 each, wk
    # and wv [64, 1, 16] 4,096 each; the router [64, 4] 1,024 (its expert
    # dim split over model); wi, wg [2, 64, 32] and wo [2, 32, 64] 16,384
    # each; shared wi, wg [64, 16] and wo [16, 64] 4,096 each
    gather = 2 * 8_192 + 2 * 4_096 + 1_024 + 3 * 16_384 + 3 * 4_096
    # all-reduces, x2 each: the attention out-projection and the shared
    # expert's down-projection (heads and mlp split over model), T · 64 ·
    # 2 B each at T = 2 · 512; the MoE combine T · 64 · 4 B (f32)
    t = 2 * 512
    reduce = 2 * (2 * t * 64 * 2 + t * 64 * 4)
    assert unit == {"all-reduce": reduce, "all-gather": gather,
                    "reduce-scatter": 0, "all-to-all": 0,
                    "collective-permute": 0, "total": reduce + gather}


def test_train_collectives_on_two_by_two():
    """The gradients: reduce-scatter of each leaf gathered over data (its
    shard at rest), all-reduce over data of each leaf left whole there."""
    cfg = _moe_cfg().scaled(n_units=1, remat=False)
    shape = ShapeConfig("t", 512, 4, "train")
    prog = dryrun.Program(cfg, shape, TWO)
    got = dryrun.collective_bytes(prog)
    rs = ar = 0
    for (path, leaf), dims in zip(tree_leaves_with_path(prog.pspecs),
                                  dryrun.tree_leaves(prog.gathered)):
        if path[0] == "mtp":
            continue
        gathered = {a for d, _ in dims for a in dryrun._names(leaf.spec[d])
                    if TWO.shape[a] > 1}
        partial = {"data"} | ({"model"} if path[-1] == "router" else set())
        rs += leaf.local_nbytes if gathered & partial else 0
        ar += leaf.local_nbytes if partial - gathered else 0
    assert got["reduce-scatter"] == rs > 0
    assert got["all-reduce"] >= 2 * ar > 0


# ----------------------------------------------------------------------
# the full configs on the production mesh
# ----------------------------------------------------------------------
def test_smollm_heads_are_replicated_on_a_16_wide_axis():
    cfg = get_config("smollm-360m")
    prog = dryrun.Program(cfg, get_shape("decode_32k"),
                          make_production_mesh())
    att = prog.compute_shapes["units"]["0"]["mixer"]
    assert att["wq"] == (32, 960, 15, 64) and att["wk"] == (32, 960, 5, 64)
    assert att["wo"] == (32, 15, 64, 960)
    assert prog.cfg_dev.n_heads == 15 and prog.cfg_dev.n_kv_heads == 5
    # the MLP and the vocab split over model, the batch over data, the
    # cache's sequence over model (the kv heads could not take it)
    assert prog.compute_shapes["units"]["0"]["ffn"]["wi"] == (32, 960, 160)
    assert prog.compute_shapes["embed"] == (3072, 960)
    assert prog.b_local == 8
    assert prog.inputs["cache"]["units"]["0"]["k"].local_shape == \
        (32, 8, 5, 2048, 64)
    rec = dryrun.run_cell("smollm-360m", "decode_32k", False)
    # per layer: q, k, v, o at every head, 2 · 8 · 960 · (15 + 5 + 5) · 64
    # + 2 · 8 · 960 · 960 = 39,321,600; the MLP's 160-wide slice,
    # 3 · 2 · 8 · 960 · 160 = 7,372,800; the core over 2,048 cached
    # positions, 2 · 2 · 8 · 15 · 2048 · 64 = 62,914,560; x 32 layers,
    # plus the head's slice 2 · 8 · 960 · 3072 = 47,185,920
    assert rec["flops_per_device"] == 32 * (
        39_321_600 + 7_372_800 + 62_914_560) + 47_185_920 == 3_554_672_640
    assert rec["collective_bytes_per_device"]["all-to-all"] == 0


def test_deepseek_v3_counts_the_routed_slice():
    cfg = get_config("deepseek-v3-671b")
    prog = dryrun.Program(cfg, get_shape("train_4k"),
                          make_production_mesh())
    ffn = prog.compute_shapes["units"]["0"]["ffn"]
    # 256 experts over 16: 16 a device, d_model gathered; the router whole
    assert ffn["wi"] == (58, 16, 7168, 2048)
    assert ffn["router"] == (58, 7168, 256)
    assert prog.b_local == 16 and prog.cfg_dev.n_heads == 8
    assert prog.cfg_dev.moe.impl == "alltoall"


def test_model_mesh_split_q_heads_read_their_kv_heads():
    """yi-6b: 32 q heads split over model, 4 kv heads replicated; without
    a cache a device's 2 q heads read one kv head, with one (decode) its
    core runs every head over its 2,048 cached positions."""
    mesh = make_production_mesh()
    cfg = get_config("yi-6b")
    train = dryrun.Program(cfg, get_shape("train_4k"), mesh)
    assert (train.cfg_dev.n_heads, train.cfg_dev.n_kv_heads) == (2, 1)
    dec = dryrun.Program(cfg, get_shape("decode_32k"), mesh)
    assert (dec.cfg_dev.n_heads, dec.cfg_dev.n_kv_heads) == (32, 4)
    assert dec.inputs["cache"]["units"]["0"]["k"].local_shape[-2] == 2048
    coll = dryrun.collective_bytes(dec)
    # each layer all-gathers q: 8 · 1 · 32 · 128 · 2 B
    assert coll["all-gather"] >= 32 * 8 * 32 * 128 * 2


# ----------------------------------------------------------------------
# the model hooks stay off real tensors
# ----------------------------------------------------------------------
def test_device_heads_and_cache_slice_only_on_meta():
    from repro_torch.models.layers import _cache_write, _device_heads

    t = torch.zeros(2, 4, 3, 8)
    assert _device_heads(t, 4) is t
    with pytest.raises(ValueError):
        _device_heads(t, 2)
    assert _device_heads(t.to("meta"), 2).shape == (2, 2, 3, 8)
    assert _device_heads(t.to("meta"), 8).shape == (2, 8, 3, 8)
    buf = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError):
        _cache_write(buf, torch.ones(1, 2, 6, 8), torch.tensor(0))
    out = _cache_write(buf.to("meta"), torch.ones(1, 2, 6, 8,
                                                  device="meta"),
                       torch.tensor(0, device="meta"))
    assert out.shape == (1, 2, 4, 8)


# ----------------------------------------------------------------------
# the roofline's model half and the variants against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape.name) == \
            ref_roofline.model_flops(arch, shape.name), shape.name


def _fake_record(arch, shape, flops=1e15, mem=1e12, coll=1e10):
    # tests/test_roofline.py's record
    return {"arch": arch, "shape": shape, "mesh": "pod16x16",
            "n_devices": 256, "flops_per_device": flops,
            "bytes_per_device": mem,
            "collective_bytes_per_device": {"total": coll}}


def test_analyze_record_table_and_diagnoses_match_the_reference():
    arch, shape = ARCH_IDS[0], "train_4k"
    recs = [_fake_record(arch, shape),
            _fake_record(arch, shape, flops=1e12, mem=1e14),
            _fake_record(arch, shape, flops=1e12, coll=1e14)]
    for rec in recs:
        got = roofline.analyze_record(rec)
        want = ref_roofline.analyze_record(rec)
        t = got["terms"]
        assert t["compute_s"] == rec["flops_per_device"] / 989e12
        assert t["memory_s"] == rec["bytes_per_device"] / 3.35e12
        assert t["collective_s"] == \
            rec["collective_bytes_per_device"]["total"] / 450e9
        assert got["dominant"] == want["dominant"]
        assert got["useful_ratio"] == want["useful_ratio"]
        assert roofline.what_moves_it(got) == \
            ref_roofline.what_moves_it(want)
    assert [roofline.analyze_record(r)["dominant"] for r in recs] == \
        ["compute_s", "memory_s", "collective_s"]
    got = roofline.table(recs).splitlines()
    want = ref_roofline.table(recs).splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) == 5

    def cells(line):
        c = line.split("|")
        return c[1:4] + c[7:9]

    assert [cells(r) for r in got[2:]] == [cells(r) for r in want[2:]]
    b = roofline.analyze_record(dict(recs[0], bytes_boundary_per_device=1e9),
                                use_boundary=True)
    assert b["terms"]["memory_s"] == 1e9 / 3.35e12
    assert b["terms"]["memory_unfused_s"] == 1e12 / 3.35e12


def test_load_records_and_main(tmp_path, capsys):
    rec = dict(_fake_record("smollm-360m", "decode_32k"))
    (tmp_path / "a.json").write_text(json.dumps(rec))
    assert roofline.load_records(str(tmp_path)) == [rec]
    roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| smollm-360m | decode_32k | pod16x16 |" in out
    assert "compute-bound" in out and roofline.CARD in out
    assert os.path.basename(roofline.DRYRUN_DIR) == "dryrun_out"
    assert dryrun.OUT_DIR == roofline.DRYRUN_DIR


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_variants_equal_the_reference(arch):
    assert list(perf.VARIANTS) == list(ref_perf.VARIANTS)
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    for name, fn in perf.VARIANTS.items():
        got = dataclasses.asdict(fn(cfg))
        want = dataclasses.asdict(ref_perf.VARIANTS[name](ref_cfg))
        assert got == want, name
    assert cfg == get_config(arch)


def test_perf_main_runs_variants(capsys):
    rows = perf.main(["--arch", "deepseek-v2-lite-16b", "--shape",
                      "decode_32k", "--variants",
                      "baseline,serve_layout,serve_weights"])
    base, serve, weights = (r[1] for r in rows)
    # the serving layouts drop the per-step FSDP gathers of the weights
    assert serve["collective_s"] < base["collective_s"] / 10
    assert weights["collective_s"] < base["collective_s"] / 10
    assert "serve_layout vs baseline" in capsys.readouterr().out


# ----------------------------------------------------------------------
# the production mesh
# ----------------------------------------------------------------------
def test_production_mesh_equals_the_reference(monkeypatch):
    code = (
        "import json\n"
        "from repro.launch.mesh import make_production_mesh as m\n"
        "print(json.dumps([[dict(x.shape), list(x.axis_names)]\n"
        "                  for x in (m(), m(multi_pod=True))]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])

    def no_cuda(*a, **k):
        raise AssertionError("make_production_mesh touched CUDA")

    for name in ("is_available", "device_count", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    got = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    assert [[m.shape, list(m.axis_names)] for m in got] == want
    assert [m.size for m in got] == [256, 512]
    with use_mesh(got[1]):
        assert get_mesh() is got[1]
    assert dryrun.mesh_name(got[0]) == "pod16x16"
    assert dryrun.mesh_name(got[1]) == "pod2x16x16"


# ----------------------------------------------------------------------
# without JAX, the reference, CUDA or an environment change
# ----------------------------------------------------------------------
def test_dry_run_modules_run_without_jax_or_repro(tmp_path):
    code = (
        "import os, sys, json\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch import dryrun, perf, roofline, specs\n"
        "import torch\n"
        "assert dict(os.environ) == env\n"
        f"dryrun.main(['--arch', 'smollm-360m', '--shape', 'decode_32k',"
        f" '--out', {str(tmp_path)!r}])\n"
        "assert dict(os.environ) == env\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__sp.json")
                     .read_text())
    assert rec["flops_per_device"] == 3_554_672_640
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
