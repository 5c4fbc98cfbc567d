"""Multi-head Latent Attention (DeepSeek V2/V3, arXiv:2405.04434 §2.1).

PyTorch port of ``repro.models.mla``.  Prefill without a cache runs the
expanded form (per-head k_nope/v up-projected from the compressed
latent).  With a cache it runs the ABSORBED form: the cache holds only the
kv_lora latent and the shared rope key, W_uk is folded into the query and
W_uv into the output (cache bytes per token = kv_lora + rope_dim,
independent of head count); a prompt longer than ``q_chunk`` and a
multiple of it runs the absorbed form one query chunk at a time.

Numerics follow ``layers``: the score products take float32 operands and
return float32 (the reference's ``preferred_element_type=float32``), the
probabilities are cast to the compute dtype before the context product,
``scale`` is the reference's float32 ``1 / sqrt(dn + dr)``, and masked
scores are -1e30.  The latent cache is written in place (``_cache_write``
along its sequence axis, clamped as ``dynamic_update_slice`` clamps).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import constrain
from .layers import (
    _attend,
    _attend_chunked,
    _cache_write,
    _causal_mask,
    apply_rope,
    init_rmsnorm,
    pv,
    rmsnorm,
    torch_dtype,
)


def init_mla(key, cfg, lead: Tuple[int, ...] = ()):
    """Draws, in order: ``wq_a`` and ``wq_b`` (with ``q_lora_rank``) or
    ``wq``, then ``wkv_a``, ``wk_b``, ``wv_b``, ``wk_rope``, ``wo``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    dt = torch_dtype(cfg.param_dtype)
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = pv(key, "wq_a", (d, m.q_lora_rank), ("fsdp", None), dt,
                       lead=lead)
        p["q_norm"] = init_rmsnorm(key, m.q_lora_rank, dt, lead=lead)
        p["wq_b"] = pv(
            key, "wq_b", (m.q_lora_rank, h, dn + dr),
            (None, "heads", "qk_dim"), dt, lead=lead,
        )
    else:
        p["wq"] = pv(key, "wq", (d, h, dn + dr),
                     ("fsdp", "heads", "qk_dim"), dt, lead=lead)
    p["wkv_a"] = pv(key, "wkv_a", (d, m.kv_lora_rank), ("fsdp", None), dt,
                    lead=lead)
    p["kv_norm"] = init_rmsnorm(key, m.kv_lora_rank, dt, lead=lead)
    p["wk_b"] = pv(key, "wk_b", (m.kv_lora_rank, h, dn),
                   (None, "heads", "qk_dim"), dt, lead=lead)
    p["wv_b"] = pv(key, "wv_b", (m.kv_lora_rank, h, dv),
                   (None, "heads", "head_dim"), dt, lead=lead)
    p["wk_rope"] = pv(key, "wk_rope", (d, dr), ("fsdp", None), dt,
                      lead=lead)
    p["wo"] = pv(key, "wo", (h, dv, d), ("heads", "head_dim", "fsdp"), dt,
                 fan_in=h * dv, lead=lead)
    return p


def _queries(cfg, params, xc, positions, cdt):
    m = cfg.mla
    dn, dr = m.nope_head_dim, m.rope_head_dim
    b, s, d = xc.shape
    if m.q_lora_rank:
        qa = xc @ params["wq_a"].to(cdt)
        qa = rmsnorm(qa, params["q_norm"], cfg.norm_eps)
        wq_b = params["wq_b"].to(cdt)
        q = (qa @ wq_b.reshape(m.q_lora_rank, -1)).view(
            b, s, *wq_b.shape[1:])
    else:
        wq = params["wq"].to(cdt)
        q = (xc @ wq.reshape(d, -1)).view(b, s, *wq.shape[1:])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(
        q_rope.transpose(1, 2), positions[:, None], cfg.rope_theta
    ).transpose(1, 2)
    return q_nope, q_rope  # [b, s, h, dn], [b, s, h, dr]


def _absorbed(params, cc, ckr, qa, qr, q_off, scale, cdt):
    """Attention of absorbed queries ``qa`` [b, sq, h, r] and rope queries
    ``qr`` [b, sq, h, dr] at positions ``q_off + i`` over the whole latent
    cache (``cc`` [b, skv, r], ``ckr`` [b, skv, dr]) → [b, sq, h, dv]."""
    b, sq = qa.shape[:2]
    skv = cc.shape[1]
    ccc = cc.to(cdt)
    scores = (
        torch.einsum("bshr,bpr->bhsp", qa.float(), ccc.float())
        + torch.einsum("bshr,bpr->bhsp", qr.float(), ckr.to(cdt).float())
    ) * scale
    kpos = torch.arange(skv, device=cc.device)[None, None, :]
    qpos = (q_off + torch.arange(sq, device=cc.device))[None, :, None]
    mask = (kpos <= qpos).expand(b, sq, skv)
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhsp,bpr->bshr", probs.to(cdt), ccc)
    return torch.einsum("bshr,rhv->bshv", ctx, params["wv_b"].to(cdt))


def mla_attention(
    cfg,
    params,
    x,                        # [b, s, d]
    positions,                # [b, s]
    segment_ids=None,
    cache: Optional[Dict] = None,
    q_chunk: int = 256,
):
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    # the reference's float32 1 / sqrt(dn + dr), rounded as it rounds it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))

    q_nope, q_rope = _queries(cfg, params, xc, positions, cdt)

    c = xc @ params["wkv_a"].to(cdt)
    c = rmsnorm(c, params["kv_norm"], cfg.norm_eps)
    k_rope = xc @ params["wk_rope"].to(cdt)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)   # [b, s, dr]

    if cache is not None:
        # -------- absorbed decode over the latent cache --------
        pos = cache["pos"]
        cc = _cache_write(cache["ckv"], c, pos, axis=1)
        ckr = _cache_write(cache["k_rope"], k_rope, pos, axis=1)
        new_cache = {"ckv": cc, "k_rope": ckr, "pos": pos + s}
        # fold W_uk into q:  [b,s,h,dn] x [r,h,dn] -> [b,s,h,r]
        q_abs = torch.einsum(
            "bshn,rhn->bshr", q_nope, params["wk_b"].to(cdt)
        )
        if s > q_chunk and s % q_chunk == 0:
            # chunked absorbed prefill: one query chunk at a time
            out = torch.cat([
                _absorbed(params, cc, ckr, q_abs[:, qs:qs + q_chunk],
                          q_rope[:, qs:qs + q_chunk], pos + qs, scale, cdt)
                for qs in range(0, s, q_chunk)
            ], dim=1)
        else:
            out = _absorbed(params, cc, ckr, q_abs, q_rope, pos, scale, cdt)
    else:
        # -------- expanded prefill --------
        k_nope = torch.einsum("bsr,rhn->bshn", c, params["wk_b"].to(cdt))
        v = torch.einsum("bsr,rhv->bshv", c, params["wv_b"].to(cdt))
        k_nope = constrain(k_nope, ("batch", "seq", "heads", None))
        v = constrain(v, ("batch", "seq", "heads", None))
        k_rope_h = k_rope[:, :, None, :].expand(b, s, h, dr)
        q = torch.cat((q_nope, q_rope), -1)       # [b, s, h, dn+dr]
        k = torch.cat((k_nope, k_rope_h), -1)
        qh = q.transpose(1, 2)[:, :, None]        # [b, h, 1, s, k]
        kh = k.transpose(1, 2)                    # [b, h, s, k]
        vh = v.transpose(1, 2)
        if s > q_chunk and s % q_chunk == 0:
            out = _attend_chunked(qh, kh, vh, scale, 0, q_chunk,
                                  segment_ids)
        else:
            mask = _causal_mask(s, s, 0, device=x.device)
            if segment_ids is not None:
                seg = segment_ids[:, :, None] == segment_ids[:, None, :]
                mask = mask[None] & seg
            else:
                mask = mask[None].expand(b, s, s)
            out = _attend(qh, kh, vh, mask, scale)
        out = out.reshape(b, h, s, dv).transpose(1, 2)  # [b, s, h, dv]
        new_cache = None

    out = constrain(out, ("batch", "seq", "heads", None))
    y = out.to(cdt).reshape(b, s, h * dv) @ params["wo"].to(cdt).reshape(
        h * dv, d)
    return constrain(y, ("batch", "seq", "embed")), new_cache


def init_mla_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None,
                   lead: Tuple[int, ...] = ()):
    m = cfg.mla
    lead = tuple(lead)
    return {
        "ckv": torch.zeros(lead + (batch, max_seq, m.kv_lora_rank),
                           dtype=dtype, device=device),
        "k_rope": torch.zeros(lead + (batch, max_seq, m.rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.zeros(lead, dtype=torch.int32, device=device),
    }


def mla_cache_axes():
    """The latent cache is small (kv_lora + rope per token, MLA's point),
    so it is not seq-sharded, as in the reference."""
    return {
        "ckv": ("batch", None, None),
        "k_rope": ("batch", None, None),
        "pos": (),
    }
