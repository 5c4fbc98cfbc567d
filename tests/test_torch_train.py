"""Port parity for the training path: the loss (``models.loss_fn`` with
the MoE aux and MTP losses, remat), the optimizers, the train step, the
error-feedback gradient compressor, checkpoints, ``remesh_state``, the
host mesh and the ``launch.train`` driver, each against the reference on
the CPU.

Weights cross from the reference side as numpy draws in the shapes of its
``abstract_params`` (its init depends on ``PYTHONHASHSEED``), batches come
from the data pipeline (``segment_ids`` and ``loss_mask`` included), and
every reference program that is jitted is compiled once, in a
module-scoped fixture.

Tolerances (float32 compute): the loss and its metrics within 1e-5
relative, each leaf's gradient within 1e-4 of that leaf's max |grad|
(measured with torch 2.13 and jax 0.9 on an x86-64 CPU: 1.3e-5 at worst,
Jamba); one optimizer update within 1e-6 relative of the leaf's max |x|;
one train step's params within the reference test's tolerance (rtol
2e-2, atol 2e-4 at lr 1e-3: AdamW's first step moves a leaf by lr x g /
(|g| + eps), which amplifies the gradients' f32 rounding where |g| nears
eps) and all but 0.1% of each leaf's entries within 1e-6 (measured: one
entry of 11,520 at 2.3e-5), its state within 1e-4 of the leaf's max, its
loss within 1e-5 relative;
the compressor bitwise; checkpoints bitwise.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import compression as JCOMP  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.train_step import make_train_step as j_train_step  # noqa
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig,
    TokenPipeline,
    synthetic_corpus,
)
from repro_torch.distributed import compression as TCOMP  # noqa: E402
from repro_torch.distributed.sharding import logical_to_spec  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pytree import (  # noqa: E402
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import elastic as TE  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    loss_and_grads,
    make_train_step,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
CPU = torch.device("cpu")
LOSS_ARCHS = ("smollm-360m", "deepseek-v3-671b", "jamba-1.5-large-398b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of the leaf's max |grad|
OPT_TOL = 1e-6         # of the leaf's max |x|


def _np(x):
    """A torch or jax array as numpy (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _cfgs(arch, **kw):
    """The reduced config in both packages, float32 compute, the byte
    vocab fitted as the trainer fits it.  Jamba's unit is cut to its
    first two layers (attention + MLP, then Mamba + MoE): every kind of
    layer it has, at a quarter of the reference's compile time."""
    out = []
    for mod in (JC, TC):
        c = mod.get_reduced_config(arch)
        if arch == "jamba-1.5-large-398b":
            kw = dict(kw, unit=c.unit[:2])
        out.append(c.scaled(compute_dtype="float32",
                            vocab_size=max(c.vocab_size, 260), **kw))
    return tuple(out)


def _draw(cfg, seed):
    """numpy weights in the reference's ``abstract_params`` tree: N(0, 1)
    / sqrt(fan in) for matrices, 1 + N(0, 0.1) for norm scales, and
    ``a_log`` / ``dt_bias`` ~ N(0, 0.25) (away from their zero init)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if keys[-1] in ("a_log", "dt_bias"):
            return (0.5 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = int(np.prod(shape[:-1])) if keys[-1] == "wo" else cfg.d_model
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(leaf.dtype)

    shapes, _ = JM.abstract_params(cfg)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(seq, batch, step=0):
    """A pipeline batch (tokens, labels, segment_ids, loss_mask) of the
    synthetic corpus, as numpy."""
    pipe = TokenPipeline(synthetic_corpus(16, seed=1),
                         PipelineConfig(seq_len=seq, global_batch=batch))
    return pipe.batch_at(step)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _port_grads(cfg, params, batch):
    loss, metrics, grads = loss_and_grads(cfg, params, _tb(batch))
    return loss, metrics, tree_leaves(grads)


# ----------------------------------------------------------------------
# the loss
# ----------------------------------------------------------------------
def test_ce_matches_reference():
    """``_ce`` on random logits with random masks, a masked-out row and
    an all-masked batch (the denominator floored at 1): within 1e-6
    relative of the reference's one-hot form."""
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(3, 7, 19)).astype(np.float32)
    labels = rng.randint(0, 19, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32)
    mask[1] = 0
    ce = jax.jit(JM._ce)
    for m in (mask, np.zeros_like(mask), np.ones_like(mask)):
        want = float(ce(jnp.asarray(logits), jnp.asarray(labels),
                        jnp.asarray(m)))
        got = float(TM._ce(torch.as_tensor(logits), torch.as_tensor(labels),
                           torch.as_tensor(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert float(TM._ce(torch.as_tensor(logits), torch.as_tensor(labels),
                        torch.zeros(3, 7))) == 0.0


@pytest.fixture(scope="module")
def ref_loss():
    """Per arch: the configs, drawn weights, a pipeline batch and the
    reference's ``jax.value_and_grad(loss_fn)`` on them (jitted once)."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg, tcfg = _cfgs(arch)
            params = _draw(jcfg, LOSS_ARCHS.index(arch))
            batch = _batch(32, 2)
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))
            (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, params),
                                        _jb(batch))
            out[arch] = (jcfg, tcfg, params, batch, float(loss),
                         {k: float(v) for k, v in metrics.items()},
                         jax.tree_util.tree_leaves_with_path(grads))
        return out[arch]

    return get


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(ref_loss, arch):
    """``loss_fn``'s loss, metrics (the MoE aux; DeepSeek-V3's MTP loss)
    and every leaf's gradient against ``jax.value_and_grad(loss_fn)`` in
    float32 on a pipeline batch with ``segment_ids`` and ``loss_mask``;
    every leaf is reached (the MTP head included)."""
    jcfg, tcfg, params, batch, loss, metrics, grads = ref_loss(arch)
    tparams = convert.params_from_numpy(tcfg, params, CPU)
    got_loss, got_m, got_g = _port_grads(tcfg, tparams, batch)
    np.testing.assert_allclose(float(got_loss), loss, rtol=LOSS_RTOL)
    assert set(got_m) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_m[k]), v, rtol=LOSS_RTOL,
                                   atol=1e-7)
    if jcfg.mtp:
        assert metrics["mtp_loss"] > 0
    if jcfg.moe is not None:
        assert metrics["aux_loss"] > 0
    assert len(got_g) == len(grads)
    for (path, w), g in zip(grads, got_g):
        w = np.asarray(w)
        peak = np.abs(w).max()
        assert peak > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            _np(g), w, rtol=0, atol=GRAD_TOL * peak,
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_no_value(policy):
    """``cfg.remat`` (each unit under ``torch.utils.checkpoint``; policy
    ``"dots"`` keeps the matmul outputs) against no remat on reduced
    DeepSeek-V3 (MLA, MoE aux, MTP): loss, metrics and every gradient
    bitwise on the CPU."""
    _, tcfg = _cfgs("deepseek-v3-671b")
    params, _ = TM.materialize_params(tcfg, torch.Generator().manual_seed(1),
                                      CPU)
    batch = _batch(32, 2)
    base = _port_grads(tcfg, params, batch)
    on = _port_grads(tcfg.scaled(remat=True, remat_policy=policy), params,
                     batch)
    assert torch.equal(base[0], on[0])
    assert all(torch.equal(base[1][k], on[1][k]) for k in base[1])
    assert all(torch.equal(a, b) for a, b in zip(base[2], on[2]))


# ----------------------------------------------------------------------
# optimizers
# ----------------------------------------------------------------------
def _opt_inputs(cfg, name, seed, step):
    """numpy params, grads and a state at ``step`` (zeros at 0, random
    positive moments after) in the reference's trees."""
    rng = np.random.RandomState(seed)
    params = _draw(cfg, seed)
    grads = jax.tree.map(
        lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), params)
    jopt = (JO.AdamW if name == "adamw" else JO.Adafactor)(JO.OptConfig())
    state = jax.tree.map(np.asarray, jopt.init(params))
    if step:
        state = jax.tree.map(
            lambda s: (1e-4 * np.abs(rng.randn(*s.shape))
                       + 1e-6).astype(np.float32), state)
        if name == "adamw":
            state["m"] = jax.tree.map(
                lambda s: (1e-3 * rng.randn(*s.shape)).astype(np.float32),
                state["m"])
    return jopt, params, grads, state


def _close_tree(got, want, tol=OPT_TOL):
    for g, (path, w) in zip(tree_leaves(got),
                            jax.tree_util.tree_leaves_with_path(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            _np(g), w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def ref_update():
    """The reference's ``update`` per optimizer, jitted once."""
    out = {}

    def get(name):
        if name not in out:
            jopt = (JO.AdamW if name == "adamw" else JO.Adafactor)(
                JO.OptConfig())
            out[name] = jax.jit(jopt.update)
        return out[name]

    return get


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("step", [0, 30])
def test_optimizer_update_matches_reference(ref_update, name, step):
    """One update on reduced smollm-360m's shapes (stacked units: 4-D
    attention weights, [n_units, d] norm scales) from the same numpy
    grads, state and params, at step 0 and 30 (warm-up and bias
    corrections): params, state and the global norm within 1e-6
    relative; the state's shapes and ``state_axes`` equal.  The state
    crosses with ``convert.opt_state_from_numpy``."""
    jcfg, tcfg = _cfgs("smollm-360m")
    jopt, params, grads, state = _opt_inputs(jcfg, name, 3 + step, step)
    want_p, want_s, want_n = ref_update(name)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, params), jnp.float32(step))
    topt = TO.pick_optimizer(tcfg, TO.OptConfig(name=name))
    assert type(topt).__name__ == type(jopt).__name__
    t_state = convert.opt_state_from_numpy(tcfg, topt, state, CPU)
    got_p, got_s, got_n = topt.update(
        convert.params_from_numpy(tcfg, grads, CPU), t_state,
        convert.params_from_numpy(tcfg, params, CPU), step)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=OPT_TOL)
    _close_tree(got_p, want_p)
    _close_tree(got_s, want_s)
    _, axes = JM.abstract_params(jcfg)
    _, t_axes = TM.abstract_params(tcfg)
    j_sa = jax.tree.leaves(jopt.state_axes(axes), is_leaf=lambda x: (
        isinstance(x, tuple)))
    assert tree_leaves(topt.state_axes(t_axes)) == j_sa
    assert [tuple(s.shape) for s in tree_leaves(topt.init(
        convert.params_from_numpy(tcfg, params, CPU)))] == [
        np.shape(s) for s in jax.tree.leaves(jopt.init(params))]


def test_stacked_norm_scales_take_decay_and_factoring():
    """Reference quirk, kept by the port: the stacked units' norm scales
    are [n_units, d] leaves, so ``p.ndim >= 2`` gives them weight decay
    and a factored Adafactor moment (``vr`` [n_units], ``vc`` [d]), while
    ``final_norm/scale`` [d] gets neither; the 4-D attention weights
    factor over (heads, head_dim).  With zero grads an AdamW step moves
    only the decayed leaves, in both packages alike."""
    jcfg, tcfg = _cfgs("smollm-360m")
    params = _draw(jcfg, 5)
    tparams = convert.params_from_numpy(tcfg, params, CPU)
    ln = tparams["units"]["0"]["ln_mix"]["scale"]
    assert tuple(ln.shape) == (2, 60)
    st = TO.Adafactor(TO.OptConfig()).init(tparams)["f"]
    jst = JO.Adafactor(JO.OptConfig()).init(params)["f"]
    for s in (st, jst):
        unit = s["units"]["0"]
        assert tuple(unit["ln_mix"]["scale"]["vr"].shape) == (2,)
        assert tuple(unit["ln_mix"]["scale"]["vc"].shape) == (60,)
        assert set(s["final_norm"]["scale"]) == {"v"}
        assert tuple(unit["mixer"]["wq"]["vr"].shape) == (2, 60, 3)
        assert tuple(unit["mixer"]["wq"]["vc"].shape) == (2, 60, 20)
    zeros = tree_map(torch.zeros_like, tparams)
    opt = TO.AdamW(TO.OptConfig(lr=1e-2, warmup_steps=1))
    got, _, _ = opt.update(zeros, opt.init(tparams), tparams, 0)
    jopt = JO.AdamW(JO.OptConfig(lr=1e-2, warmup_steps=1))
    want, _, _ = jax.jit(jopt.update)(jax.tree.map(jnp.zeros_like, params),
                             jopt.init(params),
                             jax.tree.map(jnp.asarray, params),
                             jnp.float32(0))
    moved = got["units"]["0"]["ln_mix"]["scale"]
    assert not torch.equal(moved, ln)
    np.testing.assert_allclose(_np(moved), np.asarray(
        want["units"]["0"]["ln_mix"]["scale"]), rtol=1e-6)
    assert torch.equal(got["final_norm"]["scale"],
                       tparams["final_norm"]["scale"])


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_pick_optimizer_full_configs(arch, monkeypatch):
    """On each full config: the port picks what the reference picks
    (Adafactor from 100B parameters), on the same analytic count (the
    reference's pick reads the count computed here once)."""
    import repro.models

    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    n = JM.count_params_analytic(jcfg)
    assert TM.count_params_analytic(tcfg) == n
    monkeypatch.setattr(repro.models, "count_params_analytic",
                        lambda cfg, active_only=False: n)
    got = TO.pick_optimizer(tcfg)
    want = JO.pick_optimizer(jcfg)
    assert type(got).__name__ == type(want).__name__
    assert got.cfg.name == want.cfg.name == (
        "adafactor" if n >= 100e9 else "adamw")


def test_global_norm_and_clip_match_reference():
    """``clip_by_global_norm`` (the reference test's case, and a tree
    under the limit) and ``lr_schedule`` through warm-up."""
    g = {"a": torch.full((4,), 10.0), "b": [torch.ones(2, 2)]}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), g), 1.0)
    assert float(norm) == pytest.approx(float(jn))
    assert float(TO.global_norm(clipped)) == pytest.approx(1.0)
    same, _ = TO.clip_by_global_norm(g, 100.0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(same),
                                                 tree_leaves(g)))
    ocfg = TO.OptConfig(lr=1e-3, warmup_steps=10)
    for s in (0, 4, 9, 50):
        assert float(TO.lr_schedule(ocfg, torch.tensor(float(s)))) == \
            float(JO.lr_schedule(JO.OptConfig(lr=1e-3, warmup_steps=10),
                                 jnp.float32(s)))


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
STEP_CASES = {"mb1": (1, None), "mb2_transform": (2, 0.5)}
# AdamW's first step moves a leaf by lr x g / (|g| + eps), a map that
# amplifies the gradients' f32 rounding where |g| nears eps: params within
# the reference test's tolerance (tests/test_train.py), and all but 0.1%
# of each leaf's entries within 1e-6
STEP_PARAM_TOL = dict(rtol=2e-2, atol=2e-4)
STEP_PARAM_CLOSE = 1e-6
STEP_PARAM_SHARE = 1e-3


@pytest.fixture(scope="module")
def ref_step():
    """Reduced smollm-360m, drawn weights, a pipeline batch of 4 rows,
    and the reference's jitted train step per case (compiled once)."""
    jcfg, tcfg = _cfgs("smollm-360m")
    params = _draw(jcfg, 7)
    batch = _batch(32, 4, step=3)
    out = {}
    for case, (mb, scale) in STEP_CASES.items():
        opt = JO.pick_optimizer(jcfg, JO.OptConfig(lr=1e-3, warmup_steps=1))
        gt = None if scale is None else (
            lambda g, s=scale: jax.tree.map(lambda x: x * s, g))
        fn = jax.jit(j_train_step(jcfg, opt, microbatches=mb,
                                  grad_transform=gt))
        p, s, m = fn(jax.tree.map(jnp.asarray, params),
                     opt.init(params), _jb(batch), jnp.float32(0))
        out[case] = (p, s, {k: float(v) for k, v in m.items()})
    return jcfg, tcfg, params, batch, out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(ref_step, case):
    """``make_train_step`` against the reference's jitted step on reduced
    smollm-360m in float32, with 1 microbatch, and with 2 and a
    ``grad_transform`` (the grads halved): params and AdamW state after
    the step, loss, metrics and grad norm."""
    jcfg, tcfg, params, batch, out = ref_step
    want_p, want_s, want_m = out[case]
    mb, scale = STEP_CASES[case]
    opt = TO.pick_optimizer(tcfg, TO.OptConfig(lr=1e-3, warmup_steps=1))
    gt = None if scale is None else (
        lambda g: tree_map(lambda x: x * scale, g))
    step = make_train_step(tcfg, opt, microbatches=mb, grad_transform=gt)
    tparams = convert.params_from_numpy(tcfg, params, CPU)
    got_p, got_s, got_m = step(tparams, opt.init(tparams), _tb(batch), 0)
    assert set(got_m) == set(want_m) == {"lm_loss", "aux_loss", "loss",
                                         "grad_norm"}
    for k, v in want_m.items():
        np.testing.assert_allclose(float(got_m[k]), v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for g, w in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **STEP_PARAM_TOL)
        far = np.abs(_np(g) - np.asarray(w)) > STEP_PARAM_CLOSE
        assert far.mean() <= STEP_PARAM_SHARE, far.sum()
    _close_tree(got_s, want_s, tol=1e-4)


# ----------------------------------------------------------------------
# gradient compression
# ----------------------------------------------------------------------
def test_error_feedback_compress_bitwise():
    """``ErrorFeedbackInt8.compress`` over five steps of random grad
    trees (a residual carried along, a heavy-tailed leaf and a zero leaf
    among them): the
    dequantized grads and the residual bitwise the reference's."""
    rng = np.random.RandomState(2)
    shape = (5, 33)       # one shape: the reference's eager ops compile once
    jc, tc = JCOMP.ErrorFeedbackInt8(), TCOMP.ErrorFeedbackInt8()

    def draw():
        return {"a": (0.01 * rng.randn(*shape)).astype(np.float32),
                "b": [(rng.randn(*shape) ** 3).astype(np.float32)],
                "z": np.zeros(shape, np.float32)}

    g0 = draw()
    j_res = jc.init(jax.tree.map(jnp.asarray, g0))
    t_res = tc.init(tree_map(torch.as_tensor, g0))
    for i in range(5):
        g = g0 if i == 0 else draw()
        j_dq, j_res = jc.compress(jax.tree.map(jnp.asarray, g), j_res)
        t_dq, t_res = tc.compress(tree_map(torch.as_tensor, g), t_res)
        for a, b in zip(tree_leaves(t_dq) + tree_leaves(t_res),
                        jax.tree.leaves(j_dq) + jax.tree.leaves(j_res)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert not np.any(tree_leaves(t_dq)[-1].numpy())


def test_compressed_psum_one_device():
    """``compressed_psum`` over an axis of extent 1 against the
    reference's on a one-device mesh (bitwise); an extent above 1 off a
    process mesh raises ``ValueError`` (``tests/test_torch_mesh.py`` runs
    it over four ranks)."""
    x = (np.random.RandomState(4).randn(257) * 3).astype(np.float32)
    want = JCOMP.compressed_psum(jnp.asarray(x), "data", j_host_mesh())
    got = TCOMP.compressed_psum(torch.as_tensor(x), "data",
                                TMESH.make_host_mesh("cpu"))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy() - x).max() <= np.abs(x).max() / 127 / 2 + 1e-6

    class Wide:
        shape = {"data": 4, "model": 1}

    with pytest.raises(ValueError, match="process mesh"):
        TCOMP.compressed_psum(torch.as_tensor(x), "data", Wide())


# ----------------------------------------------------------------------
# checkpoints (the reference's tests/test_train.py, then across packages)
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12).reshape(3, 4).float(),
            "b": {"c": torch.ones((2,), dtype=torch.int32)}}
    TCK.save(str(tmp_path), 5, tree, extra={"note": "x"})
    restored, manifest = TCK.restore_latest(str(tmp_path), tree)
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "x"}
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32
    assert restored["b"]["c"].tolist() == [1, 1]


def test_checkpoint_corruption_fallback(tmp_path):
    tree = {"a": torch.zeros(4)}
    TCK.save(str(tmp_path), 1, tree)
    TCK.save(str(tmp_path), 2, tree_map(lambda x: x + 2, tree))
    path = os.path.join(str(tmp_path), "step_00000002", "arrays.npz")
    with open(path, "wb") as f:
        f.write(b"garbage")
    restored, manifest = TCK.restore_latest(str(tmp_path), tree)
    assert manifest["step"] == 1
    assert torch.equal(restored["a"], torch.zeros(4))
    # a tree of another structure restores nothing
    assert TCK.restore_latest(str(tmp_path), {"b": torch.zeros(4)}) == (
        None, None)


def test_async_checkpointer_gc(tmp_path):
    ck = TCK.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, {"x": torch.full((2,), float(s))})
    ck.wait()
    assert TCK.list_steps(str(tmp_path)) == [3, 4]
    restored, _ = TCK.restore_latest(str(tmp_path), {"x": torch.zeros(2)})
    assert restored["x"].tolist() == [4.0, 4.0]


def test_async_snapshot_is_a_copy(tmp_path):
    """``save_async`` snapshots the leaves before its thread starts: an
    in-place write after the call does not reach the checkpoint."""
    x = torch.zeros(3)
    ck = TCK.AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, {"x": x})
    x += 5
    ck.wait()
    restored, _ = TCK.restore_latest(str(tmp_path), {"x": x})
    assert restored["x"].tolist() == [0.0, 0.0, 0.0]


def test_atomic_no_tmp_left(tmp_path):
    TCK.save(str(tmp_path), 7, {"x": torch.zeros(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert os.listdir(os.path.join(str(tmp_path), "step_00000007")) and \
        sorted(os.listdir(os.path.join(str(tmp_path), "step_00000007"))) \
        == ["arrays.npz", "manifest.json"]


TREES = [
    {"opt": {"m": (np.zeros(2),)},
     "params": {"a": np.zeros(1), "b": [np.zeros(1), np.zeros(1)],
                "n": None}},
    {"e": [], "f": {}, "g": (), "h": (np.zeros(1), np.zeros(2)),
     "i": [{"j": None, "k": np.zeros(3)}]},
    np.zeros(2),
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_treedef_signature_matches_jax(i):
    """The structure string and its hash equal JAX's for dicts, lists,
    tuples (one and several entries), ``None`` and empty containers."""
    tree = TREES[i]
    treedef = jax.tree.structure(tree)
    assert TCK._treedef_str(tree) == str(treedef)
    assert TCK._tree_sig(tree) == JCK._tree_sig(treedef)
    assert len(TCK._flatten(tree)) == treedef.num_leaves


@pytest.fixture(scope="module")
def ckpt_state():
    """Reduced smollm-360m's params and an AdamW state one step in
    (numpy, the reference's trees)."""
    jcfg, tcfg = _cfgs("smollm-360m")
    _, params, grads, state = _opt_inputs(jcfg, "adamw", 9, 30)
    return jcfg, tcfg, {"params": params, "opt": state}


def test_checkpoint_reference_to_port(tmp_path, ckpt_state):
    """A checkpoint the reference wrote (params and AdamW state) restores
    in the port, bitwise, on the port's own tree as ``tree_like``."""
    jcfg, tcfg, tree = ckpt_state
    JCK.save(str(tmp_path), 12, jax.tree.map(jnp.asarray, tree),
             extra={"loss": 1.5})
    opt = TO.AdamW(TO.OptConfig())
    like = {"params": TM.materialize_params(
        tcfg, torch.Generator().manual_seed(0), CPU)[0]}
    like["opt"] = opt.init(like["params"])
    restored, manifest = TCK.restore_latest(str(tmp_path), like)
    assert manifest["step"] == 12 and manifest["extra"] == {"loss": 1.5}
    for g, w in zip(tree_leaves(restored), jax.tree.leaves(tree)):
        assert np.array_equal(g.numpy(), w)


def test_checkpoint_port_to_reference(tmp_path, ckpt_state):
    """A checkpoint the port wrote through ``AsyncCheckpointer`` restores
    in the reference, bitwise, on the reference's tree."""
    jcfg, tcfg, tree = ckpt_state
    t_tree = {"params": convert.params_from_numpy(tcfg, tree["params"], CPU)}
    t_tree["opt"] = convert.opt_state_from_numpy(
        tcfg, TO.AdamW(TO.OptConfig()), tree["opt"], CPU)
    ck = TCK.AsyncCheckpointer(str(tmp_path))
    ck.save_async(4, t_tree)
    ck.wait()
    restored, manifest = JCK.restore_latest(str(tmp_path), tree)
    assert manifest["step"] == 4
    for g, w in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(g), w)


def test_bf16_leaves_roundtrip(tmp_path):
    """bf16 params (reduced DeepSeek-V3 at ``param_dtype="bfloat16"``)
    are stored as their bit patterns in ``|V2`` arrays: the port restores
    its own checkpoint and the reference's bitwise.  Reference fault,
    pinned: its restore casts ``|V2`` with ``astype`` and cannot read a
    bf16 leaf back, so ``restore_latest`` finds nothing."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", param_dtype="bfloat16")
    params = _draw(jcfg, 11)
    tparams = convert.params_from_numpy(tcfg, params, CPU)
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(tparams))
    TCK.save(str(tmp_path / "port"), 1, {"params": tparams})
    with np.load(str(tmp_path / "port" / "step_00000001" / "arrays.npz")) \
            as data:
        assert {data[k].dtype.str for k in data.files} == {"|V2", "<f4"}
    JCK.save(str(tmp_path / "ref"), 2,
             {"params": jax.tree.map(jnp.asarray, params)})
    like = {"params": tree_map(torch.zeros_like, tparams)}
    for where in ("port", "ref"):
        restored, _ = TCK.restore_latest(str(tmp_path / where), like)
        for g, w in zip(tree_leaves(restored["params"]),
                        tree_leaves(tparams)):
            assert g.dtype == w.dtype
            assert torch.equal(g.view(torch.int16) if g.dtype ==
                               torch.bfloat16 else g,
                               w.view(torch.int16) if w.dtype ==
                               torch.bfloat16 else w)
    assert JCK.restore_latest(str(tmp_path / "ref"), {"params": params}) \
        == (None, None)


# ----------------------------------------------------------------------
# elasticity and the host mesh
# ----------------------------------------------------------------------
def test_remesh_state_one_device():
    """``remesh_state`` places every leaf on the mesh's device with its
    logical spec computed; the specs on a one-device mesh name only
    axes of extent 1, as the reference's ``make_host_mesh`` specs do; a
    mesh of one process over two devices raises ``ValueError`` (several
    devices take a process mesh)."""
    _, tcfg = _cfgs("smollm-360m")
    params, axes = TM.materialize_params(tcfg, torch.Generator().manual_seed(
        0), CPU)
    mesh = TMESH.make_host_mesh("cpu")
    assert mesh.shape == dict(j_host_mesh().shape)
    placed = TE.remesh_state(params, axes, mesh)
    for a, b in zip(tree_leaves(placed), tree_leaves(params)):
        assert a.device == CPU and torch.equal(a, b)
    for (path, ax), leaf in zip(tree_leaves_with_path(axes),
                                tree_leaves(params)):
        spec = logical_to_spec(tuple(ax), mesh, tuple(leaf.shape))
        assert all(s is None or s in ("data", "model") or
                   set(s) <= {"data", "model"} for s in spec), path
    two = TMESH.HostMesh("cpu")
    two.devices = np.array([[CPU, torch.device("meta")]], dtype=object)
    with pytest.raises(ValueError, match="process mesh"):
        TE.remesh_state(params, axes, two)
    assert TE.StragglerDetector is not None and "StragglerDetector" in \
        TE.__all__


# ----------------------------------------------------------------------
# the driver
# ----------------------------------------------------------------------
def _main(capsys, *argv):
    res = TLT.main(["--reduced", "--device", "cpu", "--batch", "4",
                    "--seq", "32", "--log-every", "1", *argv])
    return res, capsys.readouterr().out


def test_launch_train_main_and_resume(tmp_path, capsys):
    """``launch.train.main`` on reduced smollm-360m on the CPU: the
    reference's printed lines, checkpoints at every ``--ckpt-every`` and
    the last step; stopped after 5 steps and resumed to 8, its params and
    AdamW state equal an uninterrupted 8-step run's bitwise."""
    whole, out = _main(capsys, "--steps", "8", "--ckpt-every", "3",
                       "--ckpt-dir", str(tmp_path / "a"))
    assert out.startswith("pipeline: ") and "done: loss" in out
    assert out.count("\nstep ") == 8 and len(whole["losses"]) == 8
    assert TCK.list_steps(str(tmp_path / "a")) == [3, 6, 7]
    assert all(np.isfinite(whole["losses"]))
    _main(capsys, "--steps", "5", "--ckpt-every", "3",
          "--ckpt-dir", str(tmp_path / "b"))
    res, out = _main(capsys, "--steps", "8", "--ckpt-every", "3",
                     "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed from step 4" in out and res["start_step"] == 5
    assert res["losses"] == whole["losses"][5:]
    for a, b in zip(tree_leaves([res["params"], res["opt_state"]]),
                    tree_leaves([whole["params"], whole["opt_state"]])):
        assert torch.equal(a, b)


def test_launch_train_compress_and_microbatches(tmp_path, capsys):
    """``--compress-grads --microbatches 2``: finite losses and a finite,
    nonzero residual; ``--resume never`` ignores a checkpoint there."""
    args = ("--steps", "3", "--compress-grads", "--microbatches", "2",
            "--ckpt-dir", str(tmp_path))
    res, _ = _main(capsys, *args)
    assert all(np.isfinite(res["losses"]))
    res_leaves = tree_leaves(res["residual"])
    assert all(bool(torch.isfinite(r).all()) for r in res_leaves)
    assert any(bool(r.any()) for r in res_leaves)
    again, out = _main(capsys, *args, "--resume", "never")
    assert "resumed" not in out and again["losses"] == res["losses"]


def test_training_runs_without_jax_or_repro(tmp_path):
    """The training path with ``jax`` and ``repro`` blocked: a reduced
    DeepSeek-V3 step (MTP, MoE aux) through ``make_train_step`` with
    Adafactor and a checkpoint round trip; the driver module imports."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_reduced_config\n"
        "from repro_torch.models import materialize_params\n"
        "from repro_torch.pytree import tree_leaves\n"
        "from repro_torch.train import make_train_step, Adafactor, OptConfig\n"
        "from repro_torch.train.checkpoint import save, restore_latest\n"
        "from repro_torch.launch import train\n"
        "cfg = get_reduced_config('deepseek-v3-671b').scaled(\n"
        "    compute_dtype='float32')\n"
        "p, _ = materialize_params(cfg, torch.Generator().manual_seed(0),\n"
        "                          'cpu')\n"
        "opt = Adafactor(OptConfig())\n"
        "rng = np.random.RandomState(0)\n"
        "b = {k: torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)))\n"
        "     for k in ('tokens', 'labels')}\n"
        "p2, s2, m = make_train_step(cfg, opt)(p, opt.init(p), b, 0)\n"
        "assert np.isfinite(float(m['loss'])) and 'mtp_loss' in m\n"
        f"save({str(tmp_path / 'ck')!r}, 0, {{'p': p2, 's': s2}})\n"
        f"r, _ = restore_latest({str(tmp_path / 'ck')!r}, "
        "{'p': p2, 's': s2})\n"
        "assert all(torch.equal(a, c) for a, c in zip(tree_leaves(r),\n"
        "           tree_leaves({'p': p2, 's': s2})))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


# ----------------------------------------------------------------------
# chip_smoke.py's [train] phase, rehearsed at reduced sizes on the CPU
# ----------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_chip_smoke_train_phase_on_cpu(capsys, monkeypatch, tmp_path):
    """The ``[train]`` phase end to end on reduced configs on the CPU,
    the card's counters and events stood in for: every check
    (a)-(g), mamba2-370m's steps and the reduced DeepSeek-V3 and Jamba
    gradients run and pass, so a broken phase fails here before the
    card; a resume that drifts fails it."""
    from repro_torch import configs as tc_mod

    cs = _chip_smoke()

    monkeypatch.setattr(tc_mod, "get_config", TC.get_reduced_config)
    monkeypatch.setattr(TLT, "get_config", TC.get_reduced_config)
    monkeypatch.setattr(cs, "TRAIN_SIZES", dict(
        xdev_batch=2, xdev_seq=16, batch=2, seq=16, steps=5, ckpt_every=2,
        resume_at=3, short=3, mamba_batch=2, mamba_seq=8, reduced_batch=2,
        reduced_seq=16))
    for name in ("empty_cache", "reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(cs, "trace_steps", lambda run, steps: (
        [run() for _ in range(steps)], {})[1])
    kept = {}
    driver = cs.train_driver

    def keep(*a):
        kept["whole"], line = driver(*a)
        return kept["whole"], line

    monkeypatch.setattr(cs, "train_driver", keep)
    cs.train_phase(types.SimpleNamespace(seed=0), CPU, "label")
    out = capsys.readouterr().out
    for tag in ("[train xdev]", "[train checkpoint]", "[train] remat",
                "[train microbatches]",
                "[train driver]", "[train resume]", "[train adafactor]",
                "[train compress]", "[train mamba]",
                "[train deepseek-v3-671b]", "[train jamba-1.5-large-398b]",
                "[train ms]", "resumed from step 2"):
        assert tag in out, tag
    line = json.loads(out.split("[train ms] label: ")[1].splitlines()[0])
    assert line["resume_bitwise"] and line["remat_bitwise"]
    assert line["xdev"]["worst_leaf_err"] == 0.0
    real = TLT.main

    def drifting(argv):
        res = real(argv)
        if res["start_step"]:
            res["params"] = tree_map(lambda t: t * 1.001, res["params"])
        return res

    monkeypatch.setattr(TLT, "main", drifting)
    with pytest.raises(AssertionError, match="resume differs"):
        cs.train_resume(types.SimpleNamespace(seed=0), CPU, str(tmp_path),
                        kept["whole"], "label")
