"""Port parity for the LM's dense half: configs, the logical-axis rules,
the layers, and the decoder as a whole, each against the reference on
the CPU.

The reference's random init folds ``hash(name)`` into its PRNG key, and
Python salts string hashes per process, so its weights cannot be
re-derived from a seed in another process (pinned below beside the port's
init, which can).  So the weights always cross from the reference side:
numpy draws in the shapes of the reference's ``abstract_params`` (or its
``materialize_params`` output), given to the reference as jnp arrays and
to the port through ``models.convert.params_from_numpy``.

Tolerances: with ``compute_dtype="float32"``, rtol = atol = 1e-5 for the
layers and atol 1e-4 for whole-model logits; cache position counters and
every integer exact.  With the configs' bf16 compute, logits (and the
hidden states and caches beside them) within atol = rtol = 5e-2.
Measured with torch 2.13 and jax 0.9 on an x86-64 Xeon CPU with AVX-512
BF16: logits at most 4.5e-2 apart (0.69 of the bound), hidden states
7.0e-2 (0.62), caches 2.3e-2 (0.34), over the six dense reduced
configs; of the bf16 layer cases only the MLP differs, by 2.0e-3.
"""
import dataclasses
import hashlib
import math
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs import base as JCB  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_map  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
DENSE = ("smollm-360m", "yi-6b", "minitron-8b", "granite-3-2b",
         "musicgen-large", "pixtral-12b")
DEEPSEEK = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
SSM = ("mamba2-370m", "jamba-1.5-large-398b")
SERVED = DENSE + DEEPSEEK + SSM
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS_F32 = dict(rtol=0, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _np(x):
    """A torch or jax array as numpy (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _axes_leaf(x):
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def _random_params(cfg, seed):
    """numpy weights in the reference's ``abstract_params`` tree: N(0, 1)
    / sqrt(fan in) for matrices (the reference's init scale), 1 + N(0,
    0.1) for the norm scales."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = int(np.prod(shape[:-1])) if keys[-1] == "wo" else cfg.d_model
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(leaf.dtype)

    shapes, _ = JM.abstract_params(cfg)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(cfg, b, s, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = (
            rng.randn(b, cfg.frontend_len, cfg.d_model) * 0.02
        ).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# configs and sharding rules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_configs_match_reference(arch):
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for getter in ("get_config", "get_reduced_config"):
        want = getattr(JC, getter)(arch)
        got = getattr(TC, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), getter
        assert got.n_layers == want.n_layers
        assert got.resolved_head_dim == want.resolved_head_dim
    assert [s.name for s in TC.SHAPES] == [s.name for s in JC.SHAPES]
    assert dataclasses.asdict(TC.get_shape("decode_32k")) == \
        dataclasses.asdict(JC.get_shape("decode_32k"))


class _Mesh:
    """What the rules read of a mesh: axis name → extent."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = (
    _Mesh(data=16, model=16),
    _Mesh(pod=2, data=8, model=16),
    _Mesh(model=16),
    _Mesh(data=4, model=2),
    _Mesh(pod=4, data=3, model=5),
)


@pytest.mark.parametrize("arch", SERVED)
def test_logical_to_spec_matches_reference(arch):
    """Entry for entry over fake meshes, with and without the shapes
    (smollm's 15 / 5 heads and granite's 49,155 vocab on a 16-wide model
    axis fall back), under the training and the serving rules, for every
    parameter and cache leaf of the full config."""
    cfg = JC.get_config(arch)
    shapes, axes = JM.abstract_params(cfg)
    t_shapes, t_axes = TM.abstract_params(TC.get_config(arch))
    cache_ax = JM.cache_axes(cfg)
    cache_shapes = jax.eval_shape(lambda: JM.init_cache(cfg, 16, 1024))
    for mesh in MESHES:
        for rules in (None, JS.SERVING_RULES):
            t_rules = None if rules is None else TS.SERVING_RULES
            want = JS.shard_params_specs(axes, mesh, shapes_tree=jax.tree.map(
                lambda s: s.shape, shapes), rules=rules)
            got = TS.shard_params_specs(t_axes, mesh, t_shapes, t_rules)
            assert [tuple(p) for p in jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, JS.P))] == \
                tree_leaves(got)
            want = JS.shard_params_specs(axes, mesh, rules=rules)
            got = TS.shard_params_specs(t_axes, mesh, rules=t_rules)
            assert [tuple(p) for p in jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, JS.P))] == \
                tree_leaves(got)
        for ax, leaf in zip(jax.tree.leaves(cache_ax, is_leaf=_axes_leaf),
                            jax.tree.leaves(cache_shapes)):
            assert TS.logical_to_spec(ax, mesh, leaf.shape) == \
                tuple(JS.logical_to_spec(ax, mesh, leaf.shape))
    assert TS.LOGICAL_RULES == JS.LOGICAL_RULES
    assert TS.SERVING_RULES == JS.SERVING_RULES
    x = torch.ones(3)
    assert TS.constrain(x, ("batch",)) is x


def test_logical_to_spec_fallbacks():
    """The divisibility fallback and the each-axis-once rule, by hand."""
    mesh = _Mesh(pod=2, data=8, model=16)
    cases = [
        (("heads", "kv_heads"), (15, 5)),            # smollm: both replicate
        (("heads", "kv_heads"), (32, 16)),           # model axis used once
        (("batch", "seq_kv"), (16, 1024)),           # seq_kv takes model
        (("batch", "seq_kv"), (4, 1024)),            # batch keeps "pod"
        (("vocab", "fsdp"), (49_155, 2048)),         # granite's vocab
        (("fsdp", None, "mlp"), (6, 3, 32)),
    ]
    for axes, shape in cases:
        assert TS.logical_to_spec(axes, mesh, shape) == \
            tuple(JS.logical_to_spec(axes, mesh, shape)), (axes, shape)
    assert TS.logical_to_spec(("heads", "kv_heads"), mesh, (15, 5)) == \
        (None, None)
    assert TS.logical_to_spec(("batch", "seq_kv"), mesh, (4, 1024)) == \
        ("pod", ("model", "data"))


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def test_rmsnorm_rope_sinusoidal():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 24).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    for dt, tol in ((np.float32, F32), ("bfloat16", BF16)):
        jx = jnp.asarray(x).astype(dt)
        # eager, as the rest of this test (the model tests run jitted)
        want = JL.rmsnorm(jx, {"scale": jnp.asarray(scale)}, 1e-6)
        got = TL.rmsnorm(_t(x).to(TL.torch_dtype(str(jnp.dtype(dt)))),
                         {"scale": _t(scale)}, 1e-6)
        assert str(got.dtype).endswith(str(jnp.dtype(dt)))
        _close(got, want, tol)
    xr = rng.randn(2, 3, 7, 16).astype(np.float32)
    pos = rng.randint(0, 500, (2, 1, 7)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        _close(TL.apply_rope(_t(xr), _t(pos), theta),
               jax.jit(partial(JL.apply_rope, theta=theta))(
                   jnp.asarray(xr), jnp.asarray(pos)), F32)
    _close(TL.rope_freqs(16, 10_000.0), JL.rope_freqs(16, 10_000.0), F32)
    p = rng.randint(0, 300, (2, 9)).astype(np.int32)
    for d in (64, 30):
        # eager, like rmsnorm: jitted, XLA's sin and cos at angles up to
        # 300 rad are ~1e-5 off the correctly rounded ones
        _close(TL.sinusoidal_pos(_t(p), d),
               JL.sinusoidal_pos(jnp.asarray(p), d), F32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attend_matches_reference(dt):
    rng = np.random.RandomState(1)
    b, kv, g, sq, skv, d = 2, 2, 3, 5, 9, 8
    q = rng.randn(b, kv, g, sq, d).astype(np.float32)
    k = rng.randn(b, kv, skv, d).astype(np.float32)
    v = rng.randn(b, kv, skv, d).astype(np.float32)
    mask = rng.rand(b, sq, skv) < 0.6
    mask[:, :, 0] = True
    mask[0, 1] = False                       # a row with every key masked
    jd, td = jnp.dtype(dt), TL.torch_dtype(dt)
    want = JL._attend(jnp.asarray(q, jd), jnp.asarray(k, jd),
                      jnp.asarray(v, jd), jnp.asarray(mask), 0.35)
    got = TL._attend(_t(q).to(td), _t(k).to(td), _t(v).to(td), _t(mask),
                     0.35)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, F32 if dt == "float32" else BF16)


def _attn_cfgs(**kw):
    """The same small config in the reference's class and the port's."""
    base = dict(name="attn", d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=48, vocab_size=64, n_units=1,
                compute_dtype="float32")
    base.update(kw)
    return (JCB.ModelConfig(unit=(JCB.LayerSpec("attn", "mlp"),), **base),
            ModelConfig(unit=(LayerSpec("attn", "mlp"),), **base))


# (name, config overrides, s, q_chunk, segments, cache (max_seq, pos,
# dtype) or None)
ATTN_CASES = [
    ("plain", {}, 7, 256, False, None),
    ("segments", {}, 7, 256, True, None),
    ("window", {"sliding_window": 3}, 7, 256, False, None),
    ("no_rope", {"pos_embed": "sinusoidal"}, 7, 256, False, None),
    ("chunked", {}, 16, 4, False, None),
    ("chunked_segments", {}, 16, 4, True, None),
    ("chunked_window", {"sliding_window": 5}, 16, 4, False, None),
    ("chunked_skip", {"causal_skip": True}, 16, 4, False, None),
    ("chunked_skip_segments", {"causal_skip": True}, 16, 4, True, None),
    ("chunked_skip_window", {"causal_skip": True, "sliding_window": 5},
     16, 4, False, None),
    ("bf16", {"compute_dtype": "bfloat16"}, 7, 256, False, None),
    ("cache_decode", {}, 1, 256, False, (16, 5, "float32")),
    ("cache_block", {}, 3, 256, False, (16, 5, "float32")),
    ("cache_window", {"sliding_window": 3}, 3, 256, False,
     (16, 5, "float32")),
    ("cache_chunked", {}, 8, 4, False, (24, 4, "float32")),
    ("cache_chunked_skip", {"causal_skip": True}, 8, 4, False,
     (24, 4, "float32")),
    ("cache_bf16", {"compute_dtype": "bfloat16"}, 2, 256, False,
     (16, 3, "bfloat16")),
]


def _attn_inputs(cfg, s, segments, seed=2):
    rng = np.random.RandomState(seed)
    d, h, kv, hd = 32, 4, 2, 8
    params = {
        name: (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)
        for name, shape, fan in (("wq", (d, h, hd), d), ("wk", (d, kv, hd), d),
                                 ("wv", (d, kv, hd), d),
                                 ("wo", (h, hd, d), h * hd))}
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    seg = None
    if segments:
        seg = np.sort(rng.randint(1, 4, (2, s)), axis=1).astype(np.int32)
    return params, x, seg


def _attn_cache(cfg, max_seq, pos, dt, seed=3):
    """A cache whose every slot holds data (stale slots past ``pos`` must
    stay unread)."""
    rng = np.random.RandomState(seed)
    shape = (2, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    jd = jnp.dtype(dt)
    want = {"k": jnp.asarray(k, jd), "v": jnp.asarray(v, jd),
            "pos": jnp.int32(pos)}
    got = {"k": _t(k).to(TL.torch_dtype(dt)), "v": _t(v).to(
        TL.torch_dtype(dt)), "pos": torch.tensor(pos, dtype=torch.int32)}
    return want, got


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_matches_reference(case):
    name, kw, s, q_chunk, segments, cache = case
    cfg, tcfg = _attn_cfgs(**kw)
    params, x, seg = _attn_inputs(cfg, s, segments)
    start = cache[1] if cache else 0
    positions = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                                (2, s)).copy()
    jc = tc = None
    if cache:
        jc, tc = _attn_cache(cfg, *cache)
    want, wcache = jax.jit(partial(JL.attention, cfg, q_chunk=q_chunk))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(positions), None if seg is None else jnp.asarray(seg),
        jc)
    got, gcache = TL.attention(
        tcfg, tree_map(_t, params), _t(x), _t(positions),
        None if seg is None else _t(seg), tc, q_chunk)
    tol = BF16 if "bf16" in name else F32
    assert str(got.dtype).endswith(str(want.dtype))
    _close(got, want, tol)
    if cache:
        assert gcache["pos"].dtype == torch.int32
        assert int(gcache["pos"]) == int(wcache["pos"])
        _close(gcache["k"], wcache["k"], tol)
        _close(gcache["v"], wcache["v"], tol)


def test_cache_write_clamps_past_max_seq():
    """``dynamic_update_slice`` clamps its start so the update fits: 4 new
    positions at pos 6 of an 8-slot cache land at slots 4-7 (slots 0-3
    untouched), while the mask and RoPE still read positions 6-9."""
    cfg, tcfg = _attn_cfgs()
    params, x, _ = _attn_inputs(cfg, 4, False)
    jc, tc = _attn_cache(cfg, 8, 6, "float32")
    old_k = tc["k"].clone()
    positions = np.broadcast_to(np.arange(6, 10, dtype=np.int32),
                                (2, 4)).copy()
    want, wcache = jax.jit(partial(JL.attention, cfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(positions), None, jc)
    got, gcache = TL.attention(tcfg, tree_map(_t, params), _t(x),
                               _t(positions), None, tc)
    _close(got, want, F32)
    _close(gcache["k"], wcache["k"], F32)
    _close(gcache["v"], wcache["v"], F32)
    assert torch.equal(gcache["k"][:, :, :4], old_k[:, :, :4])
    assert not torch.equal(gcache["k"][:, :, 4:], old_k[:, :, 4:])
    assert int(gcache["pos"]) == int(wcache["pos"]) == 10
    with pytest.raises(ValueError):
        TL._cache_write(torch.zeros(1, 1, 3, 2), torch.zeros(1, 1, 4, 2),
                        torch.tensor(0, dtype=torch.int32))


def test_mlp_matches_reference():
    for dt, tol in (("float32", F32), ("bfloat16", BF16)):
        cfg, tcfg = _attn_cfgs(compute_dtype=dt)
        rng = np.random.RandomState(5)
        params = {"wi": rng.randn(32, 48), "wg": rng.randn(32, 48),
                  "wo": rng.randn(48, 32) / 7}
        params = {k: (v / np.sqrt(32)).astype(np.float32)
                  for k, v in params.items()}
        x = rng.randn(2, 6, cfg.d_model).astype(np.float32)
        want = jax.jit(partial(JL.mlp, cfg))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        got = TL.mlp(tcfg, tree_map(_t, params), _t(x))
        assert str(got.dtype).endswith(str(want.dtype))
        _close(got, want, tol)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_runs():
    """Per (arch, compute dtype, overrides): the reference config, its
    weights (numpy) and its jitted forward and decode step, built once."""
    runs = {}

    def get(arch, dt, **kw):
        key = (arch, dt, tuple(sorted(kw.items())))
        if key not in runs:
            cfg = JC.get_reduced_config(arch).scaled(compute_dtype=dt, **kw)
            runs[key] = (
                cfg, _random_params(cfg, seed=len(runs)),
                jax.jit(partial(JM.forward, cfg)),
                jax.jit(partial(JM.decode_step, cfg)),
            )
        return runs[key]

    return get


def _serve_twice(cfg, params, batch, cache):
    """Prefill logits without a cache, then a 5-token and a 1-token decode
    step into ``cache`` — one jitted program on the reference side."""
    logits, extras, _ = JM.forward(cfg, params, batch)
    toks = batch["tokens"]
    step5, cache = JM.decode_step(cfg, params, cache, toks[:, :5])
    step1, cache = JM.decode_step(cfg, params, cache, toks[:, 5:6])
    return logits, extras["hidden"], step5, step1, cache


def _port_model(arch, dt, params_np, **kw):
    cfg = TC.get_reduced_config(arch).scaled(compute_dtype=dt, **kw)
    return cfg, convert.params_from_numpy(cfg, params_np, CPU)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_and_decode(arch, dt):
    """Prefill logits, then a 5-token and a 1-token decode step into a
    cache (float32 with float32 compute, bf16 with the configs' bf16):
    logits, hidden states, caches and positions against the reference."""
    cfg = JC.get_reduced_config(arch).scaled(compute_dtype=dt)
    params_np = _random_params(cfg, seed=DENSE.index(arch))
    tcfg, tparams = _port_model(arch, dt, params_np)
    tol = LOGITS_F32 if dt == "float32" else BF16
    batch = _batch(cfg, 2, 12, seed=1)
    want = jax.jit(partial(_serve_twice, cfg))(
        jax.tree.map(jnp.asarray, params_np), _jbatch(batch),
        JM.init_cache(cfg, 2, 24, jnp.dtype(dt)))
    tc = TM.init_cache(tcfg, 2, 24, TL.torch_dtype(dt), CPU)
    toks = _t(batch["tokens"])
    with torch.inference_mode():
        logits, extras, none = TM.forward(tcfg, tparams, _tbatch(batch))
        step5, tc = TM.decode_step(tcfg, tparams, tc, toks[:, :5])
        step1, tc = TM.decode_step(tcfg, tparams, tc, toks[:, 5:6])
    assert none is None and logits.dtype == torch.float32
    for got, w in zip((logits, extras["hidden"], step5, step1), want):
        _close(got, w, tol)
    j_leaves, t_leaves = jax.tree.leaves(want[-1]), tree_leaves(tc)
    assert len(j_leaves) == len(t_leaves)
    for w, g in zip(j_leaves, t_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            assert str(g.dtype).endswith(str(w.dtype))
            _close(g, w, tol)
    assert int(TM.cache_position(tc)) == int(JM.cache_position(want[-1])) \
        == 6


def test_logit_softcap_and_last_logits(reference_runs):
    cfg, params_np, j_fwd, _ = reference_runs(
        "granite-3-2b", "float32", logit_softcap=0.5)
    tcfg, tparams = _port_model("granite-3-2b", "float32", params_np,
                                logit_softcap=0.5)
    batch = _batch(cfg, 2, 9, seed=2)
    jparams = jax.tree.map(jnp.asarray, params_np)
    want, _, _ = j_fwd(jparams, _jbatch(batch))
    assert float(jnp.abs(want).max()) < 0.5
    got, _, _ = TM.forward(tcfg, tparams, _tbatch(batch))
    _close(got, want, LOGITS_F32)
    last, _, _ = jax.jit(partial(JM.forward, cfg, logits_mode="last"))(
        jparams, _jbatch(batch))
    got, _, _ = TM.forward(tcfg, tparams, _tbatch(batch), logits_mode="last")
    assert tuple(got.shape) == (2, 1, cfg.vocab_size)
    _close(got, last, LOGITS_F32)


@pytest.mark.parametrize("skip", [False, True])
def test_chunked_prefill_matches_reference(skip, reference_runs):
    """A 512-token prompt takes the chunked path (512 > 256 and a multiple
    of it): without a cache (``causal_skip`` picks the triangle scan) and
    into a cache (the query offset is the cache position)."""
    cfg, params_np, j_fwd, j_dec = reference_runs(
        "smollm-360m", "float32", causal_skip=skip)
    tcfg, tparams = _port_model("smollm-360m", "float32", params_np,
                                causal_skip=skip)
    jparams = jax.tree.map(jnp.asarray, params_np)
    toks = _batch(cfg, 1, 512, seed=3)["tokens"]
    want, _, _ = j_fwd(jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _, _ = TM.forward(tcfg, tparams, {"tokens": _t(toks)})
        _close(got, want, LOGITS_F32)
        if skip:
            return
        want, _ = j_dec(jparams, JM.init_cache(cfg, 1, 520, jnp.float32),
                        jnp.asarray(toks))
        got, tc = TM.decode_step(tcfg, tparams, TM.init_cache(
            tcfg, 1, 520, torch.float32, CPU), _t(toks))
    _close(got, want, LOGITS_F32)
    assert tc["units"]["0"]["pos"].tolist() == [512, 512]


@pytest.fixture(scope="module")
def reference_smollm():
    """The reference's ``materialize_params`` of reduced smollm from
    ``PRNGKey(0)`` in this process, as a numpy tree (jitted: one compile
    in place of one per op)."""
    cfg = JC.get_reduced_config("smollm-360m")
    params = jax.jit(lambda k: JM.materialize_params(cfg, k)[0])(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def test_params_from_materialized_reference(reference_smollm):
    """The reference's own ``materialize_params`` output crosses leaf for
    leaf; a leaf of the wrong shape or dtype is refused."""
    cfg = JC.get_reduced_config("smollm-360m")
    params_np = reference_smollm
    tcfg = TC.get_reduced_config("smollm-360m")
    got = convert.params_from_numpy(tcfg, params_np, CPU)
    for w, g in zip(jax.tree.leaves(params_np), tree_leaves(got)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), w)
    bad = jax.tree.map(lambda a: a, params_np)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError):
        convert.params_from_numpy(tcfg, bad, CPU)
    bad["embed"] = params_np["embed"].astype(np.float64)
    with pytest.raises(ValueError):
        convert.params_from_numpy(tcfg, bad, CPU)
    # a bf16 reference cache keeps its bits
    jc = JM.init_cache(cfg, 1, 4)
    jc = jax.tree.map(lambda a: a + jnp.asarray(1.5, a.dtype), jc)
    tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), CPU)
    assert tc["units"]["0"]["k"].dtype == torch.bfloat16
    assert float(tc["units"]["0"]["k"].float().min()) == 1.5
    assert tc["units"]["0"]["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", SERVED)
def test_abstract_params_and_count(arch):
    """Full configs on the meta device: shapes, dtypes and axes leaf for
    leaf (DeepSeek's MLA and MoE layers and V3's ``mtp`` params, the Mamba
    leaves of mamba2-370m and Jamba too), and the analytic parameter
    counts, total and active."""
    cfg = JC.get_config(arch)
    shapes, axes = JM.abstract_params(cfg)
    t_shapes, t_axes = TM.abstract_params(TC.get_config(arch))
    w, g = jax.tree.leaves(shapes), tree_leaves(t_shapes)
    assert len(w) == len(g)
    for ws, gs in zip(w, g):
        assert gs.device.type == "meta"
        assert tuple(gs.shape) == tuple(ws.shape)
        assert str(gs.dtype).endswith(str(ws.dtype))
    assert jax.tree.leaves(axes, is_leaf=_axes_leaf) == tree_leaves(t_axes)
    n = TM.count_params_analytic(TC.get_config(arch))
    assert n == JM.count_params_analytic(cfg)
    assert TC.get_config(arch).param_count() == n
    assert TC.get_config(arch).active_param_count() == \
        JM.count_params_analytic(cfg, active_only=True)
    if arch == "smollm-360m":
        assert n == 361_821_120
    if arch == "deepseek-v2-lite-16b":
        assert n == 15_706_484_224
    if arch == "mamba2-370m":
        assert n == TC.get_config(arch).active_param_count() == 368_338_432
    if arch == "jamba-1.5-large-398b":
        assert n == 397_645_855_104
        assert TC.get_config(arch).active_param_count() == 74_214_685_056
    assert jax.tree.leaves(JM.cache_axes(cfg), is_leaf=_axes_leaf) == \
        tree_leaves(TM.cache_axes(TC.get_config(arch)))


def test_port_init_is_reproducible_and_resident():
    """The port's init: the same generator seed gives the same weights,
    another seed others; params and cache land on the named device with
    the config's dtypes; a CUDA request without a GPU raises."""
    cfg = TC.get_reduced_config("smollm-360m")
    a, axes = TM.materialize_params(cfg, torch.Generator().manual_seed(7),
                                    CPU)
    b, _ = TM.materialize_params(cfg, torch.Generator().manual_seed(7), CPU)
    c, _ = TM.materialize_params(cfg, torch.Generator().manual_seed(8), CPU)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert a["units"]["0"]["mixer"]["wq"].shape == (2, 60, 3, 20)
    assert axes["units"]["0"]["mixer"]["wq"] == (
        "layers", "fsdp", "heads", "head_dim")
    model = TM.DecoderLM(cfg, a)
    assert sum(p.numel() for p in model.parameters()) == \
        TM.count_params_analytic(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 5), dtype=torch.int32)
    with torch.inference_mode():
        want, _, _ = TM.forward(cfg, a, {"tokens": toks})
        got, _, _ = model({"tokens": toks})
    assert torch.equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TM.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError):
            TM.materialize_params(cfg, torch.Generator().manual_seed(0))


def test_dense_init_scales_in_place():
    """``dense_init`` divides its float32 draw in place: the reduced
    smollm weights equal ``randn(shape) / sqrt(fan)`` drawn from the same
    seed in the same order, bit for bit."""
    cfg = TC.get_reduced_config("smollm-360m")
    params, _ = TM.materialize_params(cfg, torch.Generator().manual_seed(3),
                                      CPU)
    gen = torch.Generator().manual_seed(3)

    def draw(shape, fan):
        return torch.randn(shape, generator=gen, dtype=torch.float32) / \
            math.sqrt(fan)

    d, f, u = cfg.d_model, cfg.d_ff, (cfg.n_units,)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    want = {"embed": draw((cfg.vocab_size, d), d)}
    if not cfg.tie_embeddings:
        want["lm_head"] = draw((d, cfg.vocab_size), d)
    unit = params["units"]["0"]
    for name, shape, fan in (("wq", (d, h, hd), d), ("wk", (d, kv, hd), d),
                             ("wv", (d, kv, hd), d),
                             ("wo", (h, hd, d), h * hd)):
        assert torch.equal(unit["mixer"][name], draw(u + shape, fan)), name
    for name, shape, fan in (("wi", (d, f), d), ("wg", (d, f), d),
                             ("wo", (f, d), f)):
        assert torch.equal(unit["ffn"][name], draw(u + shape, fan)), name
    for name, w in want.items():
        assert torch.equal(params[name], w), name
    t = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    assert torch.equal(TL.dense_init(torch.Generator().manual_seed(4),
                                     (1000,), torch.float32, fan_in=7),
                       t / math.sqrt(7))


_INIT_DIGEST = r"""
import hashlib, sys
import numpy as np
if sys.argv[1] == "reference":
    import jax
    from repro.configs import get_reduced_config
    from repro.models import materialize_params
    cfg = get_reduced_config("smollm-360m")
    leaves = jax.tree.leaves(jax.jit(lambda k: materialize_params(
        cfg, k)[0])(jax.random.PRNGKey(0)))
else:
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import materialize_params
    from repro_torch.pytree import tree_leaves
    import torch
    params, _ = materialize_params(get_reduced_config("smollm-360m"),
                                   torch.Generator().manual_seed(0), "cpu")
    leaves = [x.numpy() for x in tree_leaves(params)]
print(hashlib.sha256(b"".join(
    np.ascontiguousarray(x).tobytes() for x in leaves)).hexdigest())
"""


def _digest(leaves):
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(x).tobytes() for x in leaves)).hexdigest()


def test_reference_init_depends_on_hash_seed_port_init_does_not(
        reference_smollm):
    """Reference fault, pinned: ``layers._key`` folds ``hash(name)`` into
    the PRNG key, so a process under another ``PYTHONHASHSEED`` draws
    other weights from ``PRNGKey(0)`` than this one.  The port's init
    draws from a ``torch.Generator`` in a fixed order: the same weights in
    any process.  (One process for each package, run at once.)"""
    seed = "2" if os.environ.get("PYTHONHASHSEED") == "1" else "1"
    env = dict(os.environ, PYTHONPATH=SRC, PYTHONHASHSEED=seed,
               JAX_PLATFORMS="cpu")
    procs = {which: subprocess.Popen(
        [sys.executable, "-c", _INIT_DIGEST, which], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for which in ("reference", "port")}
    here_ref = _digest(jax.tree.leaves(reference_smollm))
    port, _ = TM.materialize_params(TC.get_reduced_config("smollm-360m"),
                                    torch.Generator().manual_seed(0), CPU)
    here_port = _digest(x.numpy() for x in tree_leaves(port))
    there = {}
    for which, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        there[which] = out.strip()
    assert there["reference"] != here_ref
    assert there["port"] == here_port
