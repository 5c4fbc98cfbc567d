"""Port parity for the Mamba2 SSD block (``models/mamba.py``) and the
decoders built on it (mamba2-370m, Jamba's attention/Mamba/MoE unit),
against the reference on the CPU.

The pieces first: ``_segsum`` (the cumsum difference with its -inf mask)
and ``_ssd_chunked`` over three chunks, with and without an initial
state, against the reference's, and in float64 against the port's
recurrence (the state-space duality).  Then each branch of
``mamba_block`` on one layer's weights, with one group and with two
(``repeat_interleave``, not ``repeat``), and a d_state unlike the head
dim so that the state's [b, h, dh, ds] layout shows in its shape: no
cache (16 tokens; 12 raises, as the reference's assert), the chunked
prefill into a cached state (16 tokens), and the exact recurrence (5
tokens, 1 token).  The cache's conv windows stay in the cache's bf16
while compute is float32, bit for bit.  Then the whole reduced
mamba2-370m and Jamba: a prefill without a cache, a 16-token prefill
into the cache, a 5-token and a 1-token decode; speculative decoding on
an SSM, whose state ``_rewind`` leaves advanced on both sides.

The reference's init cannot be re-derived in another process, so the
weights are numpy draws in the shapes of its ``abstract_params``, given
to the reference as jnp arrays and to the port through
``models.convert.params_from_numpy``.  ``a_log``, ``dt_bias``, ``d_skip``
and the conv biases are drawn away from the reference's constants, so a
head-indexing slip shows.  Each reference program is jitted once.
Tolerances: float32 compute to rtol = atol = 1e-5 for a layer, atol 1e-4
for whole-model logits (and caches) with the greedy tokens exact,
position counters exact; bf16 compute within 5e-2 for a layer, and for
the whole model as its test states.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import NgramTrie as JNgramTrie  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import spec_decode as JSD  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import NgramTrie  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import spec_decode as TSD  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402

CPU = torch.device("cpu")
SSM_ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
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
    """numpy (bf16 too, bits kept) → a CPU tensor."""
    return convert._tensor(a, CPU)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _bits(x):
    """A bf16 array's bits as int16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _draw(cfg, shapes, seed):
    """numpy weights in the tree ``shapes``: N(0, 1) / sqrt(fan in) for
    matrices (the attention output's heads x head dim, an expert's middle
    axis, else the leading axis); 1 + N(0, 0.1) for norm scales; and, away
    from the reference's constants, ``a_log``, ``dt_bias`` ~ N(0, 0.25),
    ``d_skip`` ~ 1 + N(0, 0.09), conv biases ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name = keys[-1]
        if name == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name in ("a_log", "dt_bias"):
            return (0.5 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "d_skip":
            return (1 + 0.3 * rng.randn(*leaf.shape)).astype(np.float32)
        if str(name).endswith("_bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        if name == "embed":
            fan = cfg.d_model
        elif name == "wo" and "mixer" in keys:
            fan = shape[0] * shape[1]
        elif "ffn" in keys and len(shape) == 3:
            fan = shape[1]
        else:
            fan = shape[0]
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cfgs(arch, dt="float32", **ssm):
    jcfg = JC.get_reduced_config(arch)
    tcfg = TC.get_reduced_config(arch)
    return tuple(c.scaled(compute_dtype=dt, ssm=dataclasses.replace(
        c.ssm, **ssm)) for c in (jcfg, tcfg))


# ----------------------------------------------------------------------
# the SSD pieces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("init", [False, True], ids=["zero_state",
                                                      "init_state"])
def test_segsum_and_ssd_chunked(init):
    """``_segsum`` (finite entries and the -inf mask) and ``_ssd_chunked``
    over 3 chunks of 8 (4 heads, head dim 8, d_state 6): y and the final
    state [b, h, dh, ds] within 1e-5; ``_softplus`` as
    ``jax.nn.softplus``."""
    rng = np.random.RandomState(3 + init)
    b, s, h, dh, ds, chunk = 2, 24, 4, 8, 6, 8
    x = rng.randn(2, 3, 8).astype(np.float32)
    want = np.asarray(JMB._segsum(jnp.asarray(x)))
    got = TMB._segsum(_t(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want).sum() == 2 * 3 * 28
    _close(got[np.isfinite(got)], want[np.isfinite(want)], F32)

    xh = rng.randn(b, s, h, dh).astype(np.float32)
    raw = rng.randn(b, s, h).astype(np.float32) * 2
    dt = np.asarray(jax.nn.softplus(jnp.asarray(raw)))
    _close(TMB._softplus(_t(raw)), dt, dict(rtol=1e-6, atol=0))
    a = -np.exp(0.5 * rng.randn(h)).astype(np.float32)
    bm = rng.randn(b, s, h, ds).astype(np.float32)
    cm = rng.randn(b, s, h, ds).astype(np.float32)
    st = rng.randn(b, h, ds, dh).astype(np.float32) if init else None
    args = (xh, dt, a, bm, cm)
    want_y, want_f = jax.jit(JMB._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), chunk,
        None if st is None else jnp.asarray(st))
    got_y, got_f = TMB._ssd_chunked(*map(_t, args), chunk,
                                    None if st is None else _t(st))
    assert tuple(got_f.shape) == (b, h, dh, ds) == tuple(want_f.shape)
    _close(got_y, want_y, F32)
    _close(got_f, want_f, F32)


@pytest.mark.parametrize("init", [False, True], ids=["zero_state",
                                                      "init_state"])
def test_ssd_duality_float64(init):
    """The state-space duality the block's two cached branches rely on:
    in float64, ``_ssd_chunked`` over 3 chunks of 8 and ``_recurrence``
    one token at a time give one y and one final state to 1e-12 (a
    layout slip in either would not); an initial state enters the SSD as
    [b, h, ds, dh] (rounded to float32, as the reference casts it) and
    the recurrence as [b, h, dh, ds].  In float32 they part by rounding
    alone, which the card's 48-layer check (``chip_smoke.py`` [mamba
    duality]) sees grow with depth."""
    rng = np.random.RandomState(7 + init)
    b, s, h, dh, ds, chunk = 2, 24, 4, 8, 6, 8
    xh = torch.from_numpy(rng.randn(b, s, h, dh))
    dt = TMB._softplus(torch.from_numpy(rng.randn(b, s, h)))
    a = -torch.exp(torch.from_numpy(0.5 * rng.randn(h)))
    bm, cm = (torch.from_numpy(rng.randn(b, s, h, ds)) for _ in range(2))
    st = torch.from_numpy(rng.randn(b, h, dh, ds)).float().double()
    y, final = TMB._ssd_chunked(xh, dt, a, bm, cm, chunk,
                                st.transpose(-1, -2) if init else None)
    y_rec, final_rec = TMB._recurrence(
        xh, dt, a, bm, cm, st if init else torch.zeros_like(st))
    assert y.dtype == final.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y_rec.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(final.numpy(), final_rec.numpy(),
                               rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# the block
# ----------------------------------------------------------------------
# one group, and two groups with d_state 8 (unlike head_dim 16)
VARIANTS = {"g1": {}, "g2": dict(n_groups=2, d_state=8)}


@pytest.fixture(scope="module")
def block():
    """Per (variant, dtype): the configs, unit 0's Mamba weights (numpy,
    float32) and the reference's ``mamba_block`` jitted."""
    out = {}

    def get(variant, dt="float32"):
        if (variant, dt) not in out:
            jcfg, tcfg = _cfgs("mamba2-370m", dt, **VARIANTS[variant])
            shapes, _ = JM.abstract_params(jcfg)
            w = _draw(jcfg, shapes, seed=len(out))["units"]["0"]["mixer"]
            w = jax.tree.map(lambda a: a[0], w)
            out[variant, dt] = (jcfg, tcfg, w,
                                jax.jit(partial(JMB.mamba_block, jcfg)))
        return out[variant, dt]

    return get


def _block_cache(cfg, b, seed):
    """A cache with random bf16 conv windows and a random float32
    state."""
    rng = np.random.RandomState(seed)
    c = jax.tree.map(np.asarray, JMB.init_mamba_cache(cfg, b))
    out = {k: _bf16(0.5 * rng.randn(*v.shape)) for k, v in c.items()
           if k != "ssm"}
    out["ssm"] = (0.3 * rng.randn(*c["ssm"].shape)).astype(np.float32)
    return out


def _run_block(block, variant, dt, b, s, cached, x=None, seed=0):
    jcfg, tcfg, w, j_block = block(variant, dt)
    if x is None:
        x = (np.random.RandomState(seed).randn(b, s, jcfg.d_model) * 0.5
             ).astype(np.float32)
    cache = _block_cache(jcfg, b, seed + 1) if cached else None
    want = j_block(jax.tree.map(jnp.asarray, w), jnp.asarray(x),
                   None if cache is None else jax.tree.map(jnp.asarray,
                                                           cache))
    tc = None if cache is None else tree_map(_t, cache)
    with torch.inference_mode():
        got = TMB.mamba_block(tcfg, tree_map(_t, w), _t(x), tc)
    return got, want, tc


# (case, tokens, cached)
BLOCK_CASES = [("no_cache", 16, False), ("chunked_prefill", 16, True),
               ("recurrent5", 5, True), ("recurrent1", 1, True)]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mamba_block_matches_reference(variant, case, block):
    """Output and new cache of each branch against the reference's, float32
    compute and a bf16 cache: y within 1e-5; the state within 1e-5 in its
    [b, h, dh, ds] layout, float32, written into the cache's buffer; the
    windows (bf16) within one bf16 rounding of the reference's."""
    name, s, cached = case
    (y, c), (want_y, want_c), tc = _run_block(block, variant, "float32", 2,
                                              s, cached, seed=len(name))
    assert y.dtype == torch.float32
    _close(y, want_y, F32)
    if not cached:
        assert c is None and want_c is None
        return
    jcfg = block(variant)[0]
    h, dh, ds = TMB._dims(jcfg)[1], jcfg.ssm.head_dim, jcfg.ssm.d_state
    assert tuple(c["ssm"].shape) == (2, h, dh, ds) == want_c["ssm"].shape
    assert c["ssm"].dtype == torch.float32
    assert c["ssm"] is tc["ssm"] and c["conv_x"] is tc["conv_x"]
    _close(c["ssm"], want_c["ssm"], F32)
    for k in ("conv_x", "conv_b", "conv_c"):
        assert c[k].dtype == torch.bfloat16
        _close(c[k], want_c[k], dict(rtol=2 ** -8, atol=1e-6))


@pytest.mark.parametrize("case", BLOCK_CASES[1:3],
                         ids=[c[0] for c in BLOCK_CASES[1:3]])
def test_conv_windows_bit_for_bit(case, block):
    """Inputs and weights on a dyadic grid make the projections exact in
    float32 on both sides, so the new windows (float32 compute, rounded to
    the bf16 cache) must equal the reference's bit for bit: the old rows
    carried through the float32 cast and back, the new rows rounded
    alike."""
    name, s, _ = case
    jcfg, tcfg, w, _ = block("g2")
    rng = np.random.RandomState(11)
    w = dict(w)
    for k in ("w_x", "w_b", "w_c"):
        w[k] = (rng.randint(-2, 3, w[k].shape) / 2).astype(np.float32)
    x = (rng.randint(-4, 5, (2, s, jcfg.d_model)) / 4).astype(np.float32)
    want = jax.jit(partial(JMB.mamba_block, jcfg))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x),
        jax.tree.map(jnp.asarray, _block_cache(jcfg, 2, 5)))[1]
    tc = tree_map(_t, _block_cache(jcfg, 2, 5))
    old = {k: v.clone() for k, v in tc.items()}
    with torch.inference_mode():
        _, got = TMB.mamba_block(tcfg, tree_map(_t, w), _t(x), tc)
    for k in ("conv_x", "conv_b", "conv_c"):
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    if s < jcfg.ssm.d_conv - 1:
        # the window slid by s: its first rows are the old window's last
        assert torch.equal(got["conv_x"][:, :-s], old["conv_x"][:, s:])


def test_mamba_block_bf16_and_raises(block):
    """bf16 compute with a bf16 cache (the configs' own) within 5e-2 on
    the chunked and the recurrent branch; 12 tokens without a cache (not a
    multiple of the chunk of 8) raise on both sides, as the reference's
    assert does."""
    for s in (16, 5):
        (y, c), (want_y, want_c), _ = _run_block(block, "g2", "bfloat16", 2,
                                                 s, True, seed=s)
        assert y.dtype == torch.bfloat16
        _close(y, want_y, BF16)
        assert c["ssm"].dtype == torch.float32
        for k in c:
            _close(c[k], want_c[k], BF16)
    jcfg, tcfg, w, _ = block("g1")
    x = np.zeros((1, 12, jcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TMB.mamba_block(tcfg, tree_map(_t, w), _t(x))
    with pytest.raises(AssertionError):   # raised while tracing
        jax.eval_shape(partial(JMB.mamba_block, jcfg),
                       jax.tree.map(jnp.asarray, w), jnp.asarray(x))


def test_cache_and_params_layout():
    """``init_mamba_cache``, ``mamba_cache_axes`` and ``init_mamba`` as
    the reference's: shapes, dtypes (bf16 windows, float32 state, float32
    ``a_log`` / ``dt_bias`` / ``d_skip`` under bf16 params) and axes; the
    port's constants the reference's; the stacked ``lead`` axis."""
    jcfg, tcfg = _cfgs("mamba2-370m", n_groups=2, d_state=8)
    jc = JMB.init_mamba_cache(jcfg, 3)
    tc = TMB.init_mamba_cache(tcfg, 3, device=CPU)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert str(tc[k].dtype).endswith(str(jc[k].dtype)), k
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv_x"].dtype == torch.bfloat16
    assert tuple(tc["ssm"].shape) == (3, 8, 16, 8)
    assert TMB.mamba_cache_axes() == JMB.mamba_cache_axes()
    lead = TMB.init_mamba_cache(tcfg, 1, torch.float32, CPU, lead=(4,))
    assert tuple(lead["conv_b"].shape) == (4, 1, 3, 16)
    jb, tb = (c.scaled(param_dtype="bfloat16") for c in (jcfg, tcfg))
    want = jax.eval_shape(partial(JMB.init_mamba, cfg=jb),
                          jax.random.PRNGKey(0))
    got = TMB.init_mamba(torch.Generator().manual_seed(0), tb)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = (jax.tree.leaves(want[k], is_leaf=lambda p: hasattr(p, "axes")),
                tree_leaves(got[k]))
        for wl, gl in zip(w, g):
            assert tuple(gl.value.shape) == tuple(wl.value.shape), k
            assert str(gl.value.dtype).endswith(str(wl.value.dtype)), k
            assert tuple(gl.axes) == tuple(wl.axes), k
    # the reference's constants (``jnp.zeros`` / ``jnp.ones`` in its init)
    for k, v in (("a_log", 0), ("dt_bias", 0), ("d_skip", 1),
                 ("conv_x_bias", 0), ("conv_b_bias", 0), ("conv_c_bias", 0)):
        assert bool((got[k].value == v).all()), k
    assert got["a_log"].value.dtype == torch.float32
    assert got["w_x"].value.dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the decoders
# ----------------------------------------------------------------------
def _serve(cfg, params, toks, cache, no_cache=True):
    """Logits without a cache (if ``no_cache``), then a 16-token prefill
    into ``cache`` (the chunked branch), a 5-token and a 1-token decode
    (the recurrence): one jitted program on the reference side."""
    logits = None
    if no_cache:
        logits, _, _ = JM.forward(cfg, params, {"tokens": toks[:, :16]})
    pre, extras, cache = JM.forward(cfg, params, {"tokens": toks[:, :16]},
                                    cache=cache)
    step5, cache = JM.decode_step(cfg, params, cache, toks[:, 16:21])
    step1, cache = JM.decode_step(cfg, params, cache, toks[:, 21:22])
    return logits, extras["aux_loss"], pre, step5, step1, cache


def _port_serve(tcfg, tparams, toks, dt, no_cache=True):
    tc = TM.init_cache(tcfg, 2, 32, dt, CPU)
    buffers = [x for x in tree_leaves(tc) if x.is_floating_point()]
    t = torch.as_tensor(toks)
    logits = None
    with torch.inference_mode():
        if no_cache:
            logits, _, _ = TM.forward(tcfg, tparams, {"tokens": t[:, :16]})
        pre, extras, tc = TM.forward(tcfg, tparams, {"tokens": t[:, :16]},
                                     cache=tc)
        step5, tc = TM.decode_step(tcfg, tparams, tc, t[:, 16:21])
        step1, tc = TM.decode_step(tcfg, tparams, tc, t[:, 21:22])
    # every window, state and k/v buffer was written in place: the stacked
    # buffers come back, none restacked
    assert all(a is b for a, b in zip(
        buffers, [x for x in tree_leaves(tc) if x.is_floating_point()]))
    return logits, extras["aux_loss"], pre, step5, step1, tc


@pytest.fixture(scope="module")
def served():
    """Per (arch, dtype): the port's and the reference's outputs of
    ``_serve`` on the same drawn weights and tokens; the no-cache prefill
    for mamba2-370m in float32 only (the blocks' tests hold that branch,
    and Jamba's 8-layer programs are the file's costliest compiles)."""
    out = {}

    def get(arch, dt):
        if (arch, dt) not in out:
            jcfg, tcfg = _cfgs(arch, dt)
            shapes, _ = JM.abstract_params(jcfg)
            params_np = _draw(jcfg, shapes, seed=20 + SSM_ARCHS.index(arch))
            toks = np.random.RandomState(2).randint(
                0, jcfg.vocab_size, (2, 22)).astype(np.int32)
            no_cache = jcfg.moe is None and dt == "float32"
            jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
            want = jax.jit(partial(_serve, jcfg, no_cache=no_cache))(
                jax.tree.map(jnp.asarray, params_np), jnp.asarray(toks),
                JM.init_cache(jcfg, 2, 32, jdt))
            tparams = convert.params_from_numpy(tcfg, params_np, CPU)
            got = _port_serve(tcfg, tparams, toks, getattr(torch, dt),
                              no_cache)
            out[arch, dt] = (jcfg, got, want)
        return out[arch, dt]

    return get


def _pairs(got, want):
    """(port, reference) logits of two ``_serve`` runs: without a cache
    (where both ran it), the prefill into the cache, the 5-token and the
    1-token step."""
    return [(got[i], want[i]) for i in (0, 2, 3, 4)
            if got[i] is not None and want[i] is not None]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_prefill_and_decode(arch, served):
    """float32 compute and cache: logits within 1e-4 with the greedy tokens
    exact at every step, the aux loss (Jamba's MoE) within 1e-4 relative,
    every cache leaf within 1e-4 (activations up to eight layers deep, as
    the logits; integers exact), Jamba's attention ``pos`` 22 and a
    pure-SSM cache's position 0 on both sides; the stacked state buffers
    written in place (``_port_serve``) and advanced."""
    jcfg, got, want = served(arch, "float32")
    assert len(_pairs(got, want)) == (3 if jcfg.moe is not None else 4)
    for g, w in _pairs(got, want):
        assert g.dtype == torch.float32
        _close(g, w, LOGITS_F32)
        assert np.array_equal(_np(g).argmax(-1), np.asarray(w).argmax(-1))
    if jcfg.moe is not None:
        assert float(got[1]) > 0
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4)
    j_leaves, t_leaves = jax.tree.leaves(want[-1]), tree_leaves(got[-1])
    assert len(j_leaves) == len(t_leaves)
    for w, g in zip(j_leaves, t_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).endswith(str(np.asarray(w).dtype))
        if g.dtype == torch.int32:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, LOGITS_F32)
    pos = 22 if any(s.mixer == "attn" for s in jcfg.unit) else 0
    assert int(TM.cache_position(got[-1])) == \
        int(JM.cache_position(want[-1])) == pos
    unit = got[-1]["units"]["1" if pos else "0"]
    assert unit["ssm"].shape[0] == jcfg.n_units
    assert float(unit["ssm"].abs().max()) > 0


def test_mamba2_bf16(served):
    """The config's bf16 compute and a bf16 cache.  bf16 alone moves these
    logits by 0.036-0.304 from float32 on the reference itself (its bf16
    against its float32, eight weight draws; the SSD's inputs, its output
    and the conv windows each round), and the port sits 0.035-0.121 from
    the reference's bf16 on the same draws; so the logits and the caches
    are held within 2e-1 of the reference's bf16 (this draw: 0.117 and
    0.146), and the port's logits must be as close to the reference's
    float32 as the reference's own bf16 logits are (within 1.25x; this
    draw 0.64x).  Jamba's bf16 parts are held apart: its Mamba block above
    in bf16, its attention and MoE in ``test_torch_models.py`` and
    ``test_torch_moe.py``."""
    _, got, want = served("mamba2-370m", "bfloat16")
    _, _, want32 = served("mamba2-370m", "float32")
    tol = dict(rtol=0, atol=2e-1)
    for g, w in _pairs(got, want):
        _close(g, w, tol)
    for w, g in zip(jax.tree.leaves(want[-1]), tree_leaves(got[-1])):
        assert str(g.dtype).endswith(str(np.asarray(w).dtype))
        _close(g, w, tol)
    port_err = max(np.abs(_np(g) - _np(w)).max()
                   for g, w in _pairs(got, want32))
    ref_err = max(np.abs(_np(g) - _np(w)).max()
                  for g, w in _pairs(want, want32))
    assert port_err <= 1.25 * ref_err, (port_err, ref_err)


# ----------------------------------------------------------------------
# speculative decoding on an SSM (a reference fault, pinned)
# ----------------------------------------------------------------------
def test_speculative_on_ssm_matches_reference():
    """Reduced mamba2-370m, float32: a proposer fit on the greedy
    continuation's 4-grams with the last token changed drafts wrong
    tokens.  The SSM state is not rewound after a rejected draft (the
    reference's ``_rewind`` moves integer leaves only), so speculative
    output on an SSM can differ from greedy; the port gives the
    reference's tokens and stats, and adds no snapshot."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    shapes, _ = JM.abstract_params(jcfg)
    params_np = _draw(jcfg, shapes, seed=30)
    tparams = convert.params_from_numpy(tcfg, params_np, CPU)
    prompt = np.random.RandomState(4).randint(
        0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    greedy, _ = greedy_generate(tcfg, tparams, TM.init_cache(
        tcfg, 1, 64, torch.float32, CPU), prompt, 12)
    seq = [int(t) for t in prompt[0]] + greedy[0].tolist()
    rows = [seq[i - 3:i] + [(seq[i] + 1 + i % 2) % jcfg.vocab_size]
            for i in range(3, len(seq))]
    got, g_stats = TSD.speculative_generate(
        tcfg, tparams, TM.init_cache(tcfg, 1, 64, torch.float32, CPU),
        prompt, NgramTrie(n=4).fit(rows), 12, max_draft=1,
        min_confidence=0.0)
    want, w_stats = JSD.speculative_generate(
        jcfg, jax.tree.map(jnp.asarray, params_np),
        JM.init_cache(jcfg, 1, 64, jnp.float32), prompt,
        JNgramTrie(n=4).fit(rows), 12, max_draft=1, min_confidence=0.0)
    assert np.array_equal(got, want)
    assert g_stats == w_stats
    assert w_stats["proposed"] > w_stats["accepted"]


def test_rewind_leaves_ssm_state():
    """``_rewind`` on Jamba's hybrid cache: the attention ``pos`` moves
    back by k on both sides; the Mamba layers' ``ssm`` and conv windows
    are untouched (the port returns the same tensors)."""
    jcfg, tcfg = _cfgs("jamba-1.5-large-398b")
    rng = np.random.RandomState(6)
    cache = jax.tree.map(lambda a: np.asarray(a) + np.asarray(
        rng.randn(*a.shape), a.dtype) if a.dtype != jnp.int32
        else np.asarray(a) + 7, JM.init_cache(jcfg, 1, 16))
    want = JSD._rewind(jax.tree.map(jnp.asarray, cache), 3)
    tc = convert.cache_from_numpy(tcfg, cache, CPU)
    got = TSD._rewind(tc, 3)
    assert got["units"]["0"]["pos"].tolist() == [4] == \
        np.asarray(want["units"]["0"]["pos"]).tolist()
    for i in range(1, 8):
        for k in ("ssm", "conv_x", "conv_b", "conv_c"):
            g, w = got["units"][str(i)][k], want["units"][str(i)][k]
            assert g is tc["units"][str(i)][k]
            assert np.array_equal(_np(g), _np(w))
            assert np.array_equal(_np(w), _np(cache["units"][str(i)][k]))
