"""The chunk-level checkpoints of the port's chunked attention, against
the reference's chunk-level ``jax.checkpoint``s
(``repro.models.layers._attend_chunked``: the per-query-chunk body and
each step of the triangle scan).

``models.layers._attend_chunked`` runs each query chunk's ``_attend``
under ``torch.utils.checkpoint`` when autograd records, and
``_triangle_scan`` (``causal_skip=True``) each (q block, kv block) step,
carrying a q block's running ``(num, den, mx)`` through its kv steps.
Held here, on reduced smollm-360m in float32 at 512 and 1024 tokens
(q_chunk 256: 2 and 4 chunks):

- one attention layer's gradients against the reference's
  ``jax.grad`` within 1e-4 of each gradient's max |value|, on the plain
  chunk loop and on the triangle scan;
- the bytes autograd keeps for the backward pass
  (``torch.autograd.graph.saved_tensors_hooks``, each storage counted
  once: every chunk keeps the same ``k`` and ``v``): the chunk loop's
  grow linearly in the sequence (twice the bytes at twice the tokens),
  where the loop without checkpoints keeps each chunk's ``[q_chunk,
  skv]`` probabilities (quadratic); the triangle scan's stay below what
  the steps' ``[q_chunk, q_chunk]`` probability blocks alone would take;
- outputs and gradients bitwise unchanged: the chunk loop against a
  plain loop of the port's ``_attend`` with no checkpoint; the triangle
  scan's outputs against a copy of the in-place scan it replaced (whose
  slice writes autograd cannot differentiate: its backward raises), and
  its gradients against the same scan with the checkpoints taken out;
- no checkpoint where autograd does not record (``inference_mode``);
- a remat train step of the reduced model (each unit checkpointed, the
  chunk checkpoints nested inside) against ``jax.value_and_grad`` of
  the reference's loss within the train parity tests' tolerances
  (``tests/test_torch_train.py``: loss 1e-5 relative, each gradient
  1e-4 of its max), and bitwise against the port without remat;
- a unit's recompute under the forward's ambient mesh when the backward
  pass runs on another thread (autograd runs a CUDA backward on a thread
  of its own, where ``use_mesh``'s context variable is unset): reduced
  DeepSeek-V3 with the dispatch MoE, gradients bitwise those without
  remat.
"""
import dataclasses
import math
import threading
import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, TokenPipeline, synthetic_corpus,
)
from repro_torch.distributed.sharding import use_mesh  # noqa: E402
from repro_torch.models import convert, loss_fn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import materialize_params  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

ARCH = "smollm-360m"
Q_CHUNK = 256
SEQS = (512, 1024)
GRAD_TOL = 1e-4        # of each gradient's max |value|
LOSS_RTOL = 1e-5       # tests/test_torch_train.py
SCALE = 0.25


def _cfgs(**kw):
    return tuple(mod.get_reduced_config(ARCH).scaled(
        compute_dtype="float32", **kw) for mod in (JC, TC))


def _layer_inputs(cfg, b, s, seed=0):
    """numpy weights of one attention layer, its input and the output's
    cotangent."""
    rng = np.random.RandomState(seed)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    params = {"wq": rng.randn(d, h, hd) / np.sqrt(d),
              "wk": rng.randn(d, kv, hd) / np.sqrt(d),
              "wv": rng.randn(d, kv, hd) / np.sqrt(d),
              "wo": rng.randn(h, hd, d) / np.sqrt(h * hd)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(b, s, d).astype(np.float32)
    ct = rng.randn(b, s, d).astype(np.float32)
    return params, x, ct


@pytest.mark.parametrize("skip", [False, True], ids=["loop", "triangle"])
@pytest.mark.parametrize("s", SEQS)
def test_layer_gradients_match_reference(s, skip):
    """One attention layer's output and the gradients of <output,
    cotangent> with respect to its input and its four weights, against
    the reference's ``jax.grad`` within GRAD_TOL of each one's max."""
    jcfg, tcfg = _cfgs(causal_skip=skip)
    params, x, ct = _layer_inputs(tcfg, 2 if s == SEQS[0] else 1, s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), x.shape[:2])

    def jloss(p, xx):
        y, _ = JL.attention(jcfg, p, xx, jnp.asarray(pos))
        return jnp.sum(y * ct), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = TL.attention(tcfg, tp, tx, torch.as_tensor(pos.copy()))
    got = torch.autograd.grad(torch.sum(ty * torch.as_tensor(ct)),
                              [tp[k] for k in sorted(tp)] + [tx])
    want = [jg[0][k] for k in sorted(tp)] + [jg[1]]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    for name, g, w in zip(sorted(tp) + ["x"], got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


# ----------------------------------------------------------------------
# the port's own arithmetic, with and without the checkpoints
# ----------------------------------------------------------------------
def _qkv(b, s, seed=1, kvh=1, g=3, d=20):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, kvh, g, s, d, generator=gen)
    k = torch.randn(b, kvh, s, d, generator=gen)
    v = torch.randn(b, kvh, s, d, generator=gen)
    return [t.requires_grad_() for t in (q, k, v)]


def _segments(b, s, seed=2):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(np.cumsum(rng.rand(b, s) < 0.01, axis=1)
                           .astype(np.int32))


def _plain_chunks(q, k, v, scale, q_chunk, segment_ids):
    """The chunk loop with no checkpoint: the port's ``_attend`` over each
    query chunk under the causal (and segment) mask."""
    b, kvh, g, sq, _ = q.shape
    skv = k.shape[2]
    outs = []
    for qs in range(0, sq, q_chunk):
        mask = TL._causal_mask(q_chunk, skv, qs, 0, q.device)
        if segment_ids is not None:
            seg_q = segment_ids[:, qs:qs + q_chunk]
            mask = mask[None] & (seg_q[:, :, None] == segment_ids[:, None])
        else:
            mask = mask[None].expand(b, q_chunk, skv)
        outs.append(TL._attend(q[:, :, :, qs:qs + q_chunk], k, v, mask,
                               scale))
    return torch.cat(outs, dim=3)


def _inplace_triangle_scan(q, k, v, scale, q_offset, q_chunk, segment_ids):
    """The triangle scan the checkpointed one replaced: the running
    ``num`` / ``den`` / ``mx`` written into slices in place."""
    b, kvh, g, sq, _ = q.shape
    skv = k.shape[2]
    dv = v.shape[-1]
    n_kv = skv // q_chunk
    num = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32)
    den = torch.zeros((b, kvh, g, sq), dtype=torch.float32)
    mx = torch.full((b, kvh, g, sq, 1), -math.inf, dtype=torch.float32)
    ar = torch.arange(q_chunk)
    for qi in range(sq // q_chunk):
        qs = qi * q_chunk
        q_blk = q[:, :, :, qs:qs + q_chunk].float()
        for ki in range(min(qi + 1, n_kv)):
            ks = ki * q_chunk
            k_blk = k[:, :, ks:ks + q_chunk]
            v_blk = v[:, :, ks:ks + q_chunk]
            s = torch.einsum("bkgqd,bkpd->bkgqp", q_blk, k_blk.float()) \
                * scale
            msk = ar[None, :] + ks <= ar[:, None] + q_offset + qs
            if segment_ids is not None:
                seg_q = segment_ids[:, qs:qs + q_chunk]
                seg_k = segment_ids[:, ks:ks + q_chunk]
                msk = msk[None] & (seg_q[:, :, None] == seg_k[:, None, :])
                msk = msk[:, None, None]
            else:
                msk = msk[None, None, None]
            s = torch.where(msk, s, -1e30)
            cur_mx = mx[:, :, :, qs:qs + q_chunk]
            blk_mx = torch.amax(s, dim=-1, keepdim=True)
            new_mx = torch.maximum(cur_mx, blk_mx)
            corr = torch.exp(cur_mx - new_mx)
            p = torch.exp(s - new_mx)
            num[:, :, :, qs:qs + q_chunk] = (
                num[:, :, :, qs:qs + q_chunk] * corr
                + torch.einsum("bkgqp,bkpd->bkgqd", p.to(v.dtype).float(),
                               v_blk.float()))
            den[:, :, :, qs:qs + q_chunk] = (
                den[:, :, :, qs:qs + q_chunk] * corr[..., 0]
                + torch.sum(p, dim=-1))
            mx[:, :, :, qs:qs + q_chunk] = new_mx
    return num / torch.clamp(den[..., None], min=1e-30)


def _no_checkpoints(monkeypatch):
    monkeypatch.setattr(TL, "_chunk_checkpoint", lambda fn, *a: fn(*a))


def _grads(out, qkv, seed=3):
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed))
    return torch.autograd.grad(torch.sum(out * ct), qkv)


def _chunked(qkv, skip, seg):
    return TL._attend_chunked(*qkv, SCALE, 0, Q_CHUNK, seg,
                              causal_skip=skip)


@pytest.mark.parametrize("segments", [False, True],
                         ids=["causal", "segments"])
@pytest.mark.parametrize("skip", [False, True], ids=["loop", "triangle"])
def test_outputs_and_gradients_bitwise_unchanged(skip, segments,
                                                 monkeypatch):
    """The checkpointed chunk loop against the plain loop of ``_attend``,
    the checkpointed triangle scan against the in-place scan (outputs)
    and against itself with the checkpoints taken out (gradients; the
    in-place scan's backward raises): bitwise, at 1024 tokens."""
    qkv = _qkv(1, SEQS[1])
    seg = _segments(1, SEQS[1]) if segments else None
    out = _chunked(qkv, skip, seg)
    got = _grads(out, qkv)
    if not skip:
        want = _plain_chunks(*qkv, SCALE, Q_CHUNK, seg)
        assert torch.equal(out, want)
        assert all(torch.equal(a, b) for a, b in zip(got, _grads(want, qkv)))
        return
    old = _inplace_triangle_scan(*qkv, SCALE, 0, Q_CHUNK, seg)
    assert torch.equal(out, old)
    with pytest.raises(RuntimeError, match="inplace operation"):
        _grads(old, qkv)
    _no_checkpoints(monkeypatch)
    plain = _chunked(qkv, skip, seg)
    assert torch.equal(out, plain)
    assert all(torch.equal(a, b) for a, b in zip(got, _grads(plain, qkv)))


def _saved_bytes(fn):
    """(output, the bytes of the storages autograd keeps for the
    backward pass while computing ``fn()``, each storage once)."""
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        kept[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(kept.values())


def test_chunk_loop_keeps_bytes_linear_in_the_sequence(monkeypatch):
    """Twice the tokens, at most twice the kept bytes (the inputs ``q``,
    ``k`` and ``v``, whichever chunk keeps them); without the
    checkpoints each chunk's probabilities are kept: over three times the
    bytes at twice the tokens."""
    def kept(s):
        qkv = _qkv(1, s)
        out, n = _saved_bytes(lambda: _chunked(qkv, False, None))
        inputs = sum(t.numel() * t.element_size() for t in qkv)
        return n, inputs, out

    (small, in_small, _), (big, in_big, _) = kept(SEQS[0]), kept(SEQS[1])
    assert big == in_big and small == in_small
    assert big <= 2 * small
    _no_checkpoints(monkeypatch)
    (p_small, _, _), (p_big, _, _) = kept(SEQS[0]), kept(SEQS[1])
    assert p_big > 3 * p_small and p_small > 4 * small


@pytest.mark.parametrize("s", SEQS)
def test_triangle_scan_keeps_no_probability_block(s, monkeypatch):
    """The kept bytes (the inputs and each step's ``(num, den, mx)``
    carry) stay below the bytes of the steps' ``[q_chunk, q_chunk]``
    probability blocks alone; without the checkpoints they exceed
    them."""
    b, kvh, g = 1, 1, 3
    qkv = _qkv(b, s, kvh=kvh, g=g)
    n = s // Q_CHUNK
    blocks = n * (n + 1) // 2 * b * kvh * g * Q_CHUNK * Q_CHUNK * 4
    _, kept = _saved_bytes(lambda: _chunked(qkv, True, None))
    assert kept < blocks
    _no_checkpoints(monkeypatch)
    _, plain = _saved_bytes(lambda: _chunked(qkv, True, None))
    assert plain > blocks


@pytest.mark.parametrize("skip", [False, True], ids=["loop", "triangle"])
def test_checkpoints_only_where_autograd_records(skip, monkeypatch):
    """One checkpoint a chunk (a step of the triangle scan) with autograd
    on; none under ``inference_mode`` or ``no_grad``, with the same
    output."""
    calls = []
    real = TL.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TL, "checkpoint", counted)
    qkv = _qkv(1, SEQS[1])
    out = _chunked(qkv, skip, None)
    n = SEQS[1] // Q_CHUNK
    assert len(calls) == (n * (n + 1) // 2 if skip else n)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            again = _chunked(qkv, skip, None)
        assert torch.equal(again, out.detach())
    assert len(calls) == (n * (n + 1) // 2 if skip else n)


# ----------------------------------------------------------------------
# a remat train step of the reduced model
# ----------------------------------------------------------------------
def _draw(cfg, seed=0):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        shape = leaf.shape[1:] if "units" in keys else leaf.shape
        fan = int(np.prod(shape[:-1])) if keys[-1] == "wo" else cfg.d_model
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, JM.abstract_params(cfg)[0])


@pytest.mark.parametrize("skip", [False, True], ids=["loop", "triangle"])
def test_remat_step_matches_reference(skip):
    """``loss_and_grads`` with remat on a 1 x 512 pipeline batch
    (``segment_ids`` and ``loss_mask``; 2 query chunks a layer, each
    checkpointed inside its unit's checkpoint): loss and metrics within
    LOSS_RTOL and each gradient within GRAD_TOL of its max against the
    reference, and bitwise against the port without remat."""
    # the pipeline's byte tokens need a vocab past 258
    jcfg, tcfg = _cfgs(causal_skip=skip, remat=True, vocab_size=260)
    params = _draw(jcfg)
    batch = TokenPipeline(synthetic_corpus(16, seed=1), PipelineConfig(
        seq_len=SEQS[0], global_batch=1)).batch_at(0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        partial(JM.loss_fn, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = convert.params_from_numpy(tcfg, params, "cpu")
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = loss_and_grads(tcfg, tparams, tbatch)
    np.testing.assert_allclose(float(got[0]), float(loss), rtol=LOSS_RTOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[1][k]), float(v),
                                   rtol=LOSS_RTOL, atol=1e-7)
    want = jax.tree.leaves(grads)
    assert len(tree_leaves(got[2])) == len(want)
    for g, w in zip(tree_leaves(got[2]), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())
    off = loss_and_grads(tcfg.scaled(remat=False), tparams, tbatch)
    assert torch.equal(got[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[2]),
                                                 tree_leaves(off[2])))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_recompute_runs_under_the_forward_mesh(policy):
    """Reduced DeepSeek-V3 with the dispatch MoE (``impl="alltoall"``)
    under a mesh ``{"model": 1}``, its backward pass run on another
    thread: every unit's recompute takes the forward's path (the MoE
    reads the ambient mesh), and the gradients equal bitwise those
    without remat."""
    cfg = TC.get_reduced_config("deepseek-v3-671b").scaled(
        compute_dtype="float32")
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, impl="alltoall"))
    params, _ = materialize_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))

    def grads(c, thread):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with use_mesh(types.SimpleNamespace(shape={"model": 1})):
            loss, _ = loss_fn(c, tree_unflatten(params, leaves),
                              {"tokens": tok, "labels": tok})
        out = {}

        def backward():
            try:
                out["g"] = torch.autograd.grad(loss, leaves)
            except Exception as exc:   # re-raised on the test's thread
                out["e"] = exc

        if not thread:
            backward()
        else:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        if "e" in out:
            raise out["e"]
        return out["g"]

    want = grads(cfg.scaled(remat=False), False)
    got = grads(cfg.scaled(remat=True, remat_policy=policy), True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
