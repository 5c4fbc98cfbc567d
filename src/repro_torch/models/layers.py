"""Core transformer layers: RMSNorm, RoPE, GQA attention (with chunked
flash-style softmax for long sequences), SwiGLU MLP.

PyTorch port of ``repro.models.layers``.  Parameters are plain trees
(``repro_torch.pytree``) of ``PV`` leaves (tensor + logical axes); the
logical axes drive the rules in ``repro_torch.distributed.sharding``.
Every product runs in ``cfg.compute_dtype`` on weights cast from their
``param_dtype`` inside the call, as the reference does; the products the
reference accumulates in float32 (``preferred_element_type``: the two
attention products, the LM head) upcast their operands to float32 first,
where a bf16 x bf16 product is exact, and return float32.

Random init draws from an explicit ``torch.Generator`` in a fixed order,
so one seed gives the same weights in any process.  (The reference folds
``hash(name)`` into its PRNG key, and Python salts string hashes per
process, so its weights cannot be re-derived from a seed.)  ``key=None``
builds the shapes on the ``meta`` device and allocates nothing.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain
from repro_torch.pytree import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else DTYPES[str(dtype)]


# ----------------------------------------------------------------------
# parameter leaves with logical axes
# ----------------------------------------------------------------------
@dataclasses.dataclass
class PV:
    """A parameter leaf: value + logical axis names."""

    value: Any
    axes: Tuple[Optional[str], ...]


def split_pv(tree):
    """PV tree → (params, axes) twin trees."""
    return (tree_map(lambda p: p.value, tree),
            tree_map(lambda p: p.axes, tree))


def _leaf_device(key: Optional[torch.Generator]) -> torch.device:
    return torch.device("meta") if key is None else key.device


def dense_init(key, shape, dtype, fan_in: Optional[int] = None,
               lead: Tuple[int, ...] = ()):
    """N(0, 1/fan) draws of ``lead + shape`` (``lead``: the stacked-unit
    axis; ``fan`` defaults to ``shape[0]``).  Scaled in place: a leaf
    never holds two float32 copies at once (DeepSeek-V2-Lite's stacked
    expert leaves are 19.19 GB each)."""
    full = tuple(lead) + tuple(shape)
    if key is None:
        return torch.empty(full, dtype=dtype, device="meta")
    fan = fan_in if fan_in is not None else shape[0]
    draw = torch.randn(full, generator=key, dtype=torch.float32,
                       device=key.device)
    return draw.div_(math.sqrt(max(fan, 1))).to(dtype)


def pv(key, name, shape, axes, dtype, fan_in=None, zeros=False, ones=False,
       lead: Tuple[int, ...] = ()):
    """One parameter leaf.  ``name`` is kept for the reference's
    signature; the port's draws depend on the order of calls only."""
    full = tuple(lead) + tuple(shape)
    if ones:
        val = torch.ones(full, dtype=dtype, device=_leaf_device(key))
    elif zeros:
        val = torch.zeros(full, dtype=dtype, device=_leaf_device(key))
    else:
        val = dense_init(key, shape, dtype, fan_in, lead)
    return PV(val, axes)


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------
def init_rmsnorm(key, d, dtype, lead: Tuple[int, ...] = ()):
    return {"scale": pv(key, "scale", (d,), ("embed",), torch.float32,
                        ones=True, lead=lead)}


def rmsnorm(x, params, eps):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ----------------------------------------------------------------------
# positions: RoPE + sinusoidal
# ----------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (
        theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                               device=device) / dim)
    )


def apply_rope(x, positions, theta):
    """x: [..., s, d] with d even; positions: [..., s].  Half-split (the
    two halves of the head dim rotate together), computed in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [d/2]
    angles = positions[..., None].float() * freqs           # [..., s, d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), -1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d):
    half = d // 2
    freqs = torch.exp(
        -math.log(10_000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions[..., None].float() * freqs
    return torch.cat((torch.sin(ang), torch.cos(ang)), dim=-1)


# ----------------------------------------------------------------------
# GQA attention
# ----------------------------------------------------------------------
def init_attention(key, cfg, lead: Tuple[int, ...] = ()):
    d, h, kv, hd = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    )
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wq": pv(key, "wq", (d, h, hd), ("fsdp", "heads", "head_dim"), dt,
                 lead=lead),
        "wk": pv(key, "wk", (d, kv, hd), ("fsdp", "kv_heads", "head_dim"),
                 dt, lead=lead),
        "wv": pv(key, "wv", (d, kv, hd), ("fsdp", "kv_heads", "head_dim"),
                 dt, lead=lead),
        "wo": pv(key, "wo", (h, hd, d), ("heads", "head_dim", "fsdp"), dt,
                 fan_in=h * hd, lead=lead),
    }


def _causal_mask(sq, skv, q_offset, sliding_window=0, device=None):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(skv, device=device)[None, :]
    m = ki <= qi
    if sliding_window > 0:
        m &= ki > qi - sliding_window
    return m  # [sq, skv]


def _attend(q, k, v, mask, scale):
    """q: [b,kv,g,sq,d]  k/v: [b,kv,skv,d]  mask: [b,sq,skv] → float32.

    Both products take float32 operands (a bf16 x bf16 product is exact
    there) and accumulate in float32, as the reference's
    ``preferred_element_type=float32``; masked scores are -1e30, and the
    probabilities are cast to ``v.dtype`` before the second product."""
    scores = torch.einsum(
        "bkgqd,bkpd->bkgqp", q.float(), k.float()
    ) * scale
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bkgqp,bkpd->bkgqd", probs.to(v.dtype).float(), v.float()
    )


def _attend_chunked(q, k, v, scale, q_offset, q_chunk, segment_ids,
                    sliding_window=0, causal_skip=False):
    """Flash-style: a loop over query chunks, each with a full-kv softmax
    under the causal mask — peak memory O(q_chunk · skv).

    ``causal_skip=True`` (with an int ``q_offset`` of 0, ``skv`` a multiple
    of ``q_chunk`` and no sliding window) visits only the static list of
    lower-triangle (q block, kv block) pairs with an online softmax, as
    the reference's scan mode does.  (The reference's cost-measurement
    mode, ``unroll_scans``, computes this case with static kv slices
    instead; the port keeps the scan mode's arithmetic.)"""
    b, kvh, g, sq, _ = q.shape
    skv = k.shape[2]
    n_chunks = sq // q_chunk
    dv = v.shape[-1]
    # the chunks' closures name no tensor of this scope but the batch's
    # segment ids: a checkpoint keeps its closure until the backward pass
    device = q.device

    def mask_for(qs, kv_hi):
        mask = _causal_mask(q_chunk, kv_hi, q_offset + qs, sliding_window,
                            device)
        if segment_ids is not None:
            seg_q = segment_ids[:, qs:qs + q_chunk]
            seg_k = segment_ids[:, :kv_hi]
            return mask[None] & (seg_q[:, :, None] == seg_k[:, None, :])
        return mask[None].expand(b, q_chunk, kv_hi)

    if (causal_skip and skv % q_chunk == 0 and sliding_window == 0
            and isinstance(q_offset, int) and q_offset == 0):
        return _triangle_scan(q, k, v, scale, q_offset, q_chunk,
                              segment_ids).to(q.dtype)

    def body(qs, q_blk, k, v):
        # the mask is built here: passed in, each chunk's would be kept
        return _attend(q_blk, k, v, mask_for(qs, skv), scale)

    outs = []
    for i in range(n_chunks):
        qs = i * q_chunk
        outs.append(_chunk_checkpoint(partial(body, qs),
                                      q[:, :, :, qs:qs + q_chunk], k, v))
    return torch.cat(outs, dim=3).reshape(b, kvh, g, sq, dv)


def _chunk_checkpoint(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when autograd
    records: the backward pass recomputes a chunk's probabilities instead
    of keeping them (the reference's chunk-level ``jax.checkpoint``;
    memory only, never values).  Nested inside a unit's remat, as the
    reference's nest inside its scan body's.  Nothing here draws random
    numbers, so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _triangle_scan(q, k, v, scale, q_offset, q_chunk, segment_ids):
    """Online softmax over the lower-triangle (q block, kv block) pairs,
    q block outer, kv block inner (the reference's ``_triangle_scan``).
    Each q block's running ``(num, den, mx)`` is carried through its kv
    steps, each step checkpointed (``_chunk_checkpoint``), and the blocks
    are concatenated at the end."""
    b, kvh, g, sq, _ = q.shape
    skv = k.shape[2]
    dv, v_dtype = v.shape[-1], v.dtype
    n_kv = skv // q_chunk
    ar = torch.arange(q_chunk, device=q.device)

    # as in ``_attend_chunked``, the step's closure names no input tensor
    def step(qs, ks, q_blk, k_blk, v_blk, num, den, mx):
        s = torch.einsum("bkgqd,bkpd->bkgqp", q_blk, k_blk.float()) * scale
        msk = ar[None, :] + ks <= ar[:, None] + q_offset + qs
        if segment_ids is not None:
            seg_q = segment_ids[:, qs:qs + q_chunk]
            seg_k = segment_ids[:, ks:ks + q_chunk]
            msk = msk[None] & (seg_q[:, :, None] == seg_k[:, None, :])
            msk = msk[:, None, None]
        else:
            msk = msk[None, None, None]
        s = torch.where(msk, s, -1e30)
        blk_mx = torch.amax(s, dim=-1, keepdim=True)
        new_mx = torch.maximum(mx, blk_mx)
        corr = torch.exp(mx - new_mx)
        p = torch.exp(s - new_mx)
        num = num * corr + torch.einsum(
            "bkgqp,bkpd->bkgqd", p.to(v_dtype).float(), v_blk.float())
        den = den * corr[..., 0] + torch.sum(p, dim=-1)
        return num, den, new_mx

    nums, dens = [], []
    for qi in range(sq // q_chunk):
        qs = qi * q_chunk
        q_blk = q[:, :, :, qs:qs + q_chunk].float()
        carry = (
            torch.zeros((b, kvh, g, q_chunk, dv), dtype=torch.float32,
                        device=q.device),
            torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32,
                        device=q.device),
            torch.full((b, kvh, g, q_chunk, 1), -math.inf,
                       dtype=torch.float32, device=q.device),
        )
        for ki in range(min(qi + 1, n_kv)):
            ks = ki * q_chunk
            carry = _chunk_checkpoint(
                partial(step, qs, ks), q_blk, k[:, :, ks:ks + q_chunk],
                v[:, :, ks:ks + q_chunk], *carry)
        nums.append(carry[0])
        dens.append(carry[1])
    num, den = torch.cat(nums, dim=3), torch.cat(dens, dim=3)
    return num / torch.clamp(den[..., None], min=1e-30)


def _cache_write(buf, update, pos, axis=2):
    """``buf[..., start:start + s, ...] = update`` along ``axis`` (the
    sequence axis: 2 for the attention cache's [b, kv, seq, hd], 1 for
    MLA's latent [b, seq, r]) with the start clamped to ``[0, max_seq -
    s]``, as ``lax.dynamic_update_slice`` clamps it: a write at ``pos + s
    > max_seq`` lands at ``max_seq - s``.  In place, with no host read of
    ``pos``: the cache is consumed by the step, as the reference's jitted
    decode donates it."""
    s, max_seq = update.shape[axis], buf.shape[axis]
    if s > max_seq:
        if buf.device.type != "meta":
            raise ValueError(f"{s} new positions do not fit a cache of "
                             f"{max_seq}")
        # the dry run's sequence-sharded cache (launch/dryrun.py): this
        # device writes its slice of the prompt
        update, s = update.narrow(axis, 0, max_seq), max_seq
    start = torch.clamp(pos, 0, max_seq - s)
    idx = start + torch.arange(s, device=buf.device)
    buf.index_copy_(axis, idx, update.to(buf.dtype))
    return buf


def _device_heads(t, n):
    """``t`` [b, heads, ...] with ``n`` heads.  Only the dry run's
    per-device program (``launch/dryrun.py``, meta tensors) asks for
    another count than ``t`` has: there a device projects the q and kv
    heads its layout holds, and its attention core reads the heads its
    cache holds (or, without a cache, the kv heads its q heads need), so
    kv heads are cut to the first ``n`` and q heads tiled up to ``n`` (the
    all-gather of q), and the core's output is cut back to the device's
    q heads."""
    have = t.shape[1]
    if have == n:
        return t
    if t.device.type != "meta":
        raise ValueError(f"{have} heads where the config has {n}: only the "
                         "dry run's meta program splits heads")
    if n < have:
        return t[:, :n]
    return t.repeat(1, n // have, *([1] * (t.ndim - 2)))


def attention(
    cfg,
    params,
    x,                       # [b, s, d]
    positions,               # [b, s]
    segment_ids=None,        # [b, s] packed-sequence ids
    cache: Optional[Dict] = None,
    q_chunk: int = 256,
):
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    # the heads projected: the config's, but for the dry run's per-device
    # program (``_device_heads``)
    hq, kvp = params["wq"].shape[-2], params["wk"].shape[-2]
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)

    q = (xc @ params["wq"].to(cdt).reshape(d, hq * hd)).view(b, s, hq, hd)
    k = (xc @ params["wk"].to(cdt).reshape(d, kvp * hd)).view(b, s, kvp, hd)
    v = (xc @ params["wv"].to(cdt).reshape(d, kvp * hd)).view(b, s, kvp, hd)
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))

    if cfg.pos_embed == "rope":
        q = apply_rope(q.transpose(1, 2), positions[:, None], cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), positions[:, None], cfg.rope_theta)
    else:
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    v = v.transpose(1, 2)                            # [b, kv, s, hd]

    # the reference's float32 1 / sqrt(hd), rounded as it rounds it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qh = _device_heads(q, h).reshape(b, kv, g, s, hd)
    chunked = s > q_chunk and s % q_chunk == 0
    new_cache = None
    if cache is not None:
        # decode: append k/v at cache["pos"], attend over the full cache
        pos = cache["pos"]
        ck = _cache_write(cache["k"], k, pos)
        cv = _cache_write(cache["v"], v, pos)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        ck, cv = _device_heads(ck, kv), _device_heads(cv, kv)
        skv = ck.shape[2]
        if chunked:
            # chunked prefill-into-cache (flash-style, q_offset = pos)
            out = _attend_chunked(
                qh, ck.to(cdt), cv.to(cdt), scale, pos, q_chunk, None,
                cfg.sliding_window, causal_skip=cfg.causal_skip,
            )
        else:
            kpos = torch.arange(skv, device=x.device)[None, None, :]
            qpos = (pos + torch.arange(s, device=x.device))[None, :, None]
            mask = kpos <= qpos
            if cfg.sliding_window > 0:
                mask = mask & (kpos > qpos - cfg.sliding_window)
            mask = mask.expand(b, s, skv)
            out = _attend(qh, ck.to(cdt), cv.to(cdt), mask, scale)
    else:
        k, v = _device_heads(k, kv), _device_heads(v, kv)
        if chunked:
            out = _attend_chunked(
                qh, k, v, scale, 0, q_chunk, segment_ids,
                cfg.sliding_window, causal_skip=cfg.causal_skip,
            )
        else:
            mask = _causal_mask(s, s, 0, cfg.sliding_window, x.device)
            if segment_ids is not None:
                seg = segment_ids[:, :, None] == segment_ids[:, None, :]
                mask = mask[None] & seg
            else:
                mask = mask[None].expand(b, s, s)
            out = _attend(qh, k, v, mask, scale)

    out = _device_heads(out.reshape(b, h, s, hd), hq).transpose(1, 2)
    out = constrain(out, ("batch", "seq", "heads", None))   # [b, s, h, hd]
    y = out.to(cdt).reshape(b, s, hq * hd) @ params["wo"].to(cdt).reshape(
        hq * hd, d)
    y = constrain(y, ("batch", "seq", "embed"))
    return y, new_cache


def init_attention_cache(cfg, batch, max_seq, dtype=torch.bfloat16,
                         device=None, lead: Tuple[int, ...] = ()):
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, kv, max_seq, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, kv, max_seq, hd), dtype=dtype,
                         device=device),
        "pos": torch.zeros(lead, dtype=torch.int32, device=device),
    }


def attention_cache_axes():
    return {
        "k": ("batch", "kv_heads", "seq_kv", None),
        "v": ("batch", "kv_heads", "seq_kv", None),
        "pos": (),
    }


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------
def init_mlp(key, cfg, d_ff: Optional[int] = None,
             lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wi": pv(key, "wi", (d, f), ("fsdp", "mlp"), dt, lead=lead),
        "wg": pv(key, "wg", (d, f), ("fsdp", "mlp"), dt, lead=lead),
        "wo": pv(key, "wo", (f, d), ("mlp", "fsdp"), dt, fan_in=f,
                 lead=lead),
    }


def mlp(cfg, params, x):
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    h = xc @ params["wi"].to(cdt)
    gate = xc @ params["wg"].to(cdt)
    h = F.silu(gate) * h
    h = constrain(h, ("batch", "seq", "mlp"))
    y = h @ params["wo"].to(cdt)
    return constrain(y, ("batch", "seq", "embed"))
