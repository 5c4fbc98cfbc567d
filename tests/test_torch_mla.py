"""Port parity for Multi-head Latent Attention (``models/mla.py``) and the
DeepSeek decoders built on it, against the reference on the CPU.

Each MLA branch on the reference's shapes, with and without
``q_lora_rank`` (reduced DeepSeek-V2-Lite has none, reduced DeepSeek-V3
has 48): the expanded prefill without a cache (``_attend``, packed
segments, and ``_attend_chunked`` at 512 tokens), the absorbed decode
over the latent cache, the chunked absorbed prefill of 512 tokens, and
the cache write clamped where ``lax.dynamic_update_slice`` clamps it.
Then the whole reduced DeepSeek-V2-Lite and V3 (MLA prefix layers, MLA +
MoE units, V3's ``mtp`` params carried across): prefill, a 5-token and a
1-token decode step.

The reference's init cannot be re-derived in another process, so the
weights are numpy draws in the shapes of its ``abstract_params`` (or of
one MLA layer's tree), given to the reference as jnp arrays and to the
port through ``models.convert.params_from_numpy``.  Each reference
program is jitted once.  Tolerances: float32 compute to rtol = atol =
1e-5 for a layer, atol 1e-4 for whole-model logits with the greedy
tokens exact, position counters exact; bf16 compute within 5e-2 for a
layer, and for the whole model as its test states.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_map  # noqa: E402

CPU = torch.device("cpu")
DEEPSEEK = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS_F32 = dict(rtol=0, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
BF16_MODEL = dict(rtol=1e-1, atol=1e-1)


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


def _fan_in(keys, shape, cfg):
    """The contraction length of a weight: the embedding's d_model, the
    attention output's heads x head dim, an expert matrix's [E, in, out]
    middle axis, else the leading axis."""
    if keys[-1] == "embed":
        return cfg.d_model
    if keys[-1] == "wo" and "mixer" in keys:
        return shape[0] * shape[1]
    if "ffn" in keys and len(shape) == 3:
        return shape[1]
    return shape[0]


def _draw(cfg, shapes, seed):
    """numpy weights in the tree ``shapes``: N(0, 1) / sqrt(fan in) for
    matrices, 1 + N(0, 0.1) for the norm scales."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = _fan_in(keys, shape, cfg)
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cfgs(arch, dt="float32"):
    return (JC.get_reduced_config(arch).scaled(compute_dtype=dt),
            TC.get_reduced_config(arch).scaled(compute_dtype=dt))


# ----------------------------------------------------------------------
# the MLA layer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mla_layer():
    """Per arch: the configs, one MLA layer's weights (numpy, in the
    shapes of the reference's ``init_mla``) and the reference's
    ``mla_attention`` jitted."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg, tcfg = _cfgs(arch)
            shapes, _ = JM.abstract_params(jcfg)
            w = _draw(jcfg, shapes["prefix"][0]["mixer"], DEEPSEEK.index(arch))
            out[arch] = (jcfg, tcfg, w,
                         jax.jit(partial(JMLA.mla_attention, jcfg)))
        return out[arch]

    return get


def _layer_inputs(cfg, b, s, pos, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, cfg.d_model) * 0.5).astype(np.float32)
    positions = np.broadcast_to(pos + np.arange(s, dtype=np.int32),
                                (b, s)).copy()
    return x, positions


def _latent_cache(cfg, b, max_seq, pos, seed):
    """A latent cache whose first ``pos`` positions hold random latents."""
    rng = np.random.RandomState(seed)
    m = cfg.mla
    ckv = np.zeros((b, max_seq, m.kv_lora_rank), np.float32)
    ckr = np.zeros((b, max_seq, m.rope_head_dim), np.float32)
    ckv[:, :pos] = rng.randn(b, pos, m.kv_lora_rank)
    ckr[:, :pos] = rng.randn(b, pos, m.rope_head_dim)
    return {"ckv": ckv, "k_rope": ckr, "pos": np.int32(pos)}


# (case, batch, new positions, cache (max_seq, pos) or None, segments)
MLA_CASES = [
    ("expanded", 2, 12, None, False),
    ("expanded_segments", 2, 12, None, True),
    ("expanded_chunked", 1, 512, None, False),
    ("absorbed_decode5", 2, 5, (24, 7), False),
    ("absorbed_decode1", 2, 1, (24, 12), False),
    ("absorbed_chunked_prefill", 1, 512, (520, 0), False),
    ("cache_write_clamped", 2, 5, (24, 22), False),
]


@pytest.mark.parametrize("case", MLA_CASES, ids=[c[0] for c in MLA_CASES])
@pytest.mark.parametrize("arch", DEEPSEEK, ids=["no_q_lora", "q_lora"])
def test_mla_matches_reference(arch, case, mla_layer):
    """Output and new latent cache of every branch against the
    reference's, float32 compute."""
    name, b, s, cache, segments = case
    jcfg, tcfg, w, j_mla = mla_layer(arch)
    pos = 0 if cache is None else cache[1]
    x, positions = _layer_inputs(jcfg, b, s, pos, seed=len(name))
    seg = None
    if segments:
        seg = np.array([[0] * 5 + [1] * 7, [0] * 9 + [1] * 3], np.int32)
    jc = None if cache is None else _latent_cache(jcfg, b, *cache, seed=4)
    want_y, want_c = j_mla(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x), jnp.asarray(positions),
        None if seg is None else jnp.asarray(seg),
        None if jc is None else jax.tree.map(jnp.asarray, jc))
    tw = tree_map(_t, w)
    tc = None if jc is None else tree_map(_t, jc)
    with torch.inference_mode():
        got_y, got_c = TMLA.mla_attention(
            tcfg, tw, _t(x), _t(positions), None if seg is None else _t(seg),
            tc)
    assert got_y.dtype == torch.float32
    _close(got_y, want_y, F32)
    if cache is None:
        assert got_c is None and want_c is None
        return
    assert int(got_c["pos"]) == int(want_c["pos"]) == pos + s
    _close(got_c["ckv"], want_c["ckv"], F32)
    _close(got_c["k_rope"], want_c["k_rope"], F32)
    # written in place, at the clamped start
    assert got_c["ckv"] is tc["ckv"]
    start = min(pos, cache[0] - s)
    assert bool((got_c["ckv"][:, start:start + s] != 0).all())


def test_mla_bf16_and_cache_layout(mla_layer):
    """bf16 compute with a bf16 latent cache (the configs' own) within
    5e-2; ``init_mla_cache`` and ``mla_cache_axes`` as the reference's."""
    jcfg32, tcfg32, w, _ = mla_layer("deepseek-v3-671b")
    jcfg = jcfg32.scaled(compute_dtype="bfloat16")
    tcfg = tcfg32.scaled(compute_dtype="bfloat16")
    x, positions = _layer_inputs(jcfg, 2, 5, 7, seed=9)
    jc = JMLA.init_mla_cache(jcfg, 2, 24)
    tc = TMLA.init_mla_cache(tcfg, 2, 24, device=CPU)
    for k in ("ckv", "k_rope", "pos"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        assert str(tc[k].dtype).endswith(str(jc[k].dtype))
    jc["pos"] = jc["pos"] + 7
    tc["pos"] = tc["pos"] + 7
    want_y, want_c = jax.jit(partial(JMLA.mla_attention, jcfg))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x), jnp.asarray(positions),
        None, jc)
    with torch.inference_mode():
        got_y, got_c = TMLA.mla_attention(tcfg, tree_map(_t, w), _t(x),
                                          _t(positions), None, tc)
    assert got_y.dtype == torch.bfloat16
    _close(got_y, want_y, BF16)
    _close(got_c["ckv"], want_c["ckv"], BF16)
    assert TMLA.mla_cache_axes() == JMLA.mla_cache_axes()
    lead = TMLA.init_mla_cache(tcfg, 1, 8, torch.float32, CPU, lead=(3,))
    assert tuple(lead["ckv"].shape) == (3, 1, 8, 32)
    assert tuple(lead["pos"].shape) == (3,)


# ----------------------------------------------------------------------
# the DeepSeek decoders
# ----------------------------------------------------------------------
def _serve_twice(cfg, params, batch, cache):
    """Prefill logits without a cache, then a 5-token and a 1-token
    decode step into ``cache``: one jitted program on the reference
    side."""
    logits, extras, _ = JM.forward(cfg, params, batch)
    toks = batch["tokens"]
    step5, cache = JM.decode_step(cfg, params, cache, toks[:, :5])
    step1, cache = JM.decode_step(cfg, params, cache, toks[:, 5:6])
    return logits, extras["hidden"], extras["aux_loss"], step5, step1, cache


def _port_serve_twice(tcfg, tparams, toks, dt):
    tc = TM.init_cache(tcfg, 2, 24, TL.torch_dtype(dt), CPU)
    with torch.inference_mode():
        logits, extras, none = TM.forward(tcfg, tparams, {"tokens": _t(toks)})
        step5, tc = TM.decode_step(tcfg, tparams, tc, _t(toks[:, :5]))
        step1, tc = TM.decode_step(tcfg, tparams, tc, _t(toks[:, 5:6]))
    assert none is None and logits.dtype == torch.float32
    return logits, extras["hidden"], extras["aux_loss"], step5, step1, tc


def _tokens(cfg):
    return np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_forward_and_decode(arch):
    """Prefill logits, hidden states and the MoE aux loss, then a 5-token
    and a 1-token decode step into a latent cache, float32 compute:
    logits within 1e-4 with the greedy tokens exact, the aux loss within
    1e-4 relative, caches and positions against the reference."""
    jcfg, tcfg = _cfgs(arch)
    shapes, _ = JM.abstract_params(jcfg)
    params_np = _draw(jcfg, shapes, seed=10 + DEEPSEEK.index(arch))
    tparams = convert.params_from_numpy(tcfg, params_np, CPU)
    assert ("mtp" in tparams) == jcfg.mtp
    toks = _tokens(jcfg)
    want = jax.jit(partial(_serve_twice, jcfg))(
        jax.tree.map(jnp.asarray, params_np), {"tokens": jnp.asarray(toks)},
        JM.init_cache(jcfg, 2, 24, jnp.float32))
    got = _port_serve_twice(tcfg, tparams, toks, "float32")
    for g, w in zip(got[:5], want[:5]):
        _close(g, w, LOGITS_F32)
    for i in (0, 3, 4):
        assert np.array_equal(_np(got[i]).argmax(-1),
                              np.asarray(want[i]).argmax(-1))
    assert float(got[2]) > 0
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    j_leaves, t_leaves = jax.tree.leaves(want[-1]), tree_leaves(got[-1])
    assert len(j_leaves) == len(t_leaves)
    for w, g in zip(j_leaves, t_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            assert g.dtype == torch.float32
            _close(g, w, F32)
    tc = got[-1]
    carried = convert.cache_from_numpy(
        tcfg, jax.tree.map(np.asarray, want[-1]), CPU)
    for w, g in zip(j_leaves, tree_leaves(carried)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert tc["units"]["0"]["pos"].tolist() == [6] * jcfg.n_units
    assert int(TM.cache_position(tc)) == int(JM.cache_position(want[-1])) \
        == 6


def test_deepseek_v2_lite_bf16():
    """The configs' bf16 compute and a bf16 cache.  bf16 alone moves these
    logits by 0.065-0.12 from float32 on the reference itself (the
    reference's bf16 against its float32, six weight draws), and the two
    sides' elementwise ops (``silu`` first) round differently in bf16, so
    the port is held to the reference's bf16 within 1e-1 (measured
    0.049-0.089 on the same draws) and to be as close to the reference's
    float32 logits as the reference's own bf16 logits are (measured
    0.87x-1.04x).  The router's weights are zero here: every token's
    probabilities tie and both sides pick experts 0 and 1 (``lax.top_k``'s
    tie order).  With drawn routers, a bf16 rounding of the router's input
    sends a token's near-tie the other way on one side in about half the
    draws, which changes that token's output outright; the float32 cases
    above hold the router to the reference."""
    arch = "deepseek-v2-lite-16b"
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jcfg32 = jcfg.scaled(compute_dtype="float32")
    shapes, _ = JM.abstract_params(jcfg)
    params_np = _draw(jcfg, shapes, seed=10)
    params_np["units"]["0"]["ffn"]["router"][...] = 0
    tparams = convert.params_from_numpy(tcfg, params_np, CPU)
    toks = _tokens(jcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    want = jax.jit(partial(_serve_twice, jcfg))(
        jparams, {"tokens": jnp.asarray(toks)},
        JM.init_cache(jcfg, 2, 24, jnp.bfloat16))
    want32, _, _ = jax.jit(partial(JM.forward, jcfg32))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = _port_serve_twice(tcfg, tparams, toks, "bfloat16")
    for g, w in zip(got[:5], want[:5]):
        _close(g, w, BF16_MODEL)
    for w, g in zip(jax.tree.leaves(want[-1]), tree_leaves(got[-1])):
        assert str(g.dtype).endswith(str(w.dtype))
        _close(g, w, BF16_MODEL)
    port_err = np.abs(_np(got[0]) - _np(want32)).max()
    ref_err = np.abs(_np(want[0]) - _np(want32)).max()
    assert port_err <= 1.25 * ref_err, (port_err, ref_err)
