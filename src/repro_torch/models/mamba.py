"""Mamba2 block — SSD (state-space duality) formulation [arXiv:2405.21060].

PyTorch port of ``repro.models.mamba``.  The chunked SSD algorithm maps
the selective-state-space recurrence onto dense products: within-chunk
terms are an attention-like masked product, cross-chunk terms a short
Python loop over chunk states.  Decode keeps O(1) state per layer: a
(d_conv-1)-deep conv window and the [heads, head_dim, d_state] SSM state.

Shapes follow the reference: x [b,s,h,dh], B/C [b,s,g,ds] (groups
repeated in place over heads), dt [b,s,h], A scalar per head.  The SSD
and the recurrence run in float32; the conv windows live in the cache's
dtype (bf16 by default), each step's new window rounded to it.  With a
cache the block writes the new windows and the SSM state into the
cache's buffers in place (the cache is consumed, as the reference's
jitted decode donates it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from .layers import init_rmsnorm, pv, rmsnorm, torch_dtype


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba(key, cfg, lead: Tuple[int, ...] = ()):
    """Draws, in order: ``w_z``, ``w_x``, ``w_b``, ``w_c``, ``w_dt``,
    ``conv_x_w``, ``conv_b_w``, ``conv_c_w``, ``w_out``.  The conv
    biases are zeros, ``a_log`` and ``dt_bias`` float32 zeros, ``d_skip``
    float32 ones and the norm scale ones, as the reference's."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, _ = _dims(cfg)
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    # in_proj split into shard-aligned projections [z | xBC | dt] so the
    # model-axis sharding never cross-cuts a slice boundary.
    gd = s.n_groups * s.d_state
    return {
        "w_z": pv(key, "w_z", (d, d_inner), ("fsdp", "mlp"), dt, lead=lead),
        "w_x": pv(key, "w_x", (d, d_inner), ("fsdp", "mlp"), dt, lead=lead),
        "w_b": pv(key, "w_b", (d, gd), ("fsdp", "d_state"), dt, lead=lead),
        "w_c": pv(key, "w_c", (d, gd), ("fsdp", "d_state"), dt, lead=lead),
        "w_dt": pv(key, "w_dt", (d, n_heads), ("fsdp", "heads"), dt,
                   lead=lead),
        "conv_x_w": pv(key, "conv_x_w", (s.d_conv, d_inner), (None, "mlp"),
                       dt, fan_in=s.d_conv, lead=lead),
        "conv_b_w": pv(key, "conv_b_w", (s.d_conv, gd), (None, "d_state"),
                       dt, fan_in=s.d_conv, lead=lead),
        "conv_c_w": pv(key, "conv_c_w", (s.d_conv, gd), (None, "d_state"),
                       dt, fan_in=s.d_conv, lead=lead),
        "conv_x_bias": pv(key, "conv_x_bias", (d_inner,), ("mlp",), dt,
                          zeros=True, lead=lead),
        "conv_b_bias": pv(key, "conv_b_bias", (gd,), ("d_state",), dt,
                          zeros=True, lead=lead),
        "conv_c_bias": pv(key, "conv_c_bias", (gd,), ("d_state",), dt,
                          zeros=True, lead=lead),
        "a_log": pv(key, "a_log", (n_heads,), ("heads",), f32, zeros=True,
                    lead=lead),
        "dt_bias": pv(key, "dt_bias", (n_heads,), ("heads",), f32,
                      zeros=True, lead=lead),
        "d_skip": pv(key, "d_skip", (n_heads,), ("heads",), f32, ones=True,
                     lead=lead),
        "norm": init_rmsnorm(key, d_inner, dt, lead=lead),
        "w_out": pv(key, "w_out", (d_inner, d), ("mlp", "fsdp"), dt,
                    fan_in=d_inner, lead=lead),
    }


def _segsum(x):
    """[..., q] → [..., q, q]: L[i, j] = Σ_{k=j+1..i} x_k for i ≥ j, -inf
    above the diagonal (the reference's cumsum difference).

    exp(L) is the within-chunk decay matrix of the SSD recurrence."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk, init_state=None):
    """Chunked SSD scan, in float32.

    xh   [b, s, h, dh]
    dt   [b, s, h]         discretization step (post-softplus)
    a    [h]               negative decay rate (A = -exp(a_log))
    bmat [b, s, h, ds]     (groups already repeated over heads)
    cmat [b, s, h, ds]
    init_state [b, h, ds, dh] or None (zeros)
    Returns y [b, s, h, dh], final_state [b, h, dh, ds].
    """
    b, s, h, dh = xh.shape
    ds = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk

    def r(t):  # [b, s, ...] → [b, nc, chunk, ...]
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, bc, cc = r(xh), r(dt), r(bmat), r(cmat)
    da = dtc * a[None, None, None, :]                    # [b,nc,q,h]
    da_cum = torch.cumsum(da, dim=2)                     # within-chunk
    # 1) diagonal (within-chunk) term
    decay = torch.exp(_segsum(da.permute(0, 1, 3, 2)))   # [b,nc,h,q,q]
    scores = torch.einsum("bcqhs,bcphs->bchqp", cc, bc)
    y_diag = torch.einsum("bchqp,bcphd->bcqhd", scores * decay,
                          xc * dtc[..., None])
    # 2) chunk states
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # [b,nc,q,h]
    states = torch.einsum("bcqhs,bcqhd->bchsd",
                          bc * (decay_to_end * dtc)[..., None], xc)
    # 3) inter-chunk recurrence over chunk states, chunk by chunk
    chunk_decay = torch.exp(da_cum[:, :, -1, :])          # [b,nc,h]
    if init_state is None:
        state = torch.zeros((b, h, ds, dh), dtype=torch.float32,
                            device=xh.device)
    else:
        state = init_state.float()
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)               # [b,nc,h,ds,dh]
    # 4) off-diagonal (cross-chunk) contribution
    state_decay = torch.exp(da_cum)                       # [b,nc,q,h]
    y_off = torch.einsum("bcqhs,bchsd->bcqhd",
                         cc * state_decay[..., None], prev_states)
    y = (y_diag + y_off).reshape(b, s, h, dh)
    return y, state.transpose(-1, -2)                     # [b,h,dh,ds]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(seq, w, bias, prev, k):
    """Depthwise causal conv of width k: the taps summed in ascending
    order, as the reference's Python ``sum``.  ``prev`` is the (k-1)-deep
    window (in the cache's dtype, cast to ``seq``'s) or None for no cache
    (zero left-pad).  Returns (silu(conv + bias), the new window)."""
    s = seq.shape[1]
    if prev is None:
        window = F.pad(seq, (0, 0, k - 1, 0))
    else:
        window = torch.cat((prev.to(seq.dtype), seq), dim=1)
    out = window[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + window[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + bias), window[:, -(k - 1):, :]


def mamba_block(
    cfg,
    params,
    x,                           # [b, s, d]
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's three branches: no cache (the chunked SSD at
    ``min(chunk, s)``; ``s`` must be a multiple of it); a cache and ``s >
    1`` a multiple of ``cfg.ssm.chunk`` (the chunked SSD from the cached
    state); else the exact recurrence, one step a token."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    # the config's widths (``_dims``), read off the params: the dry run's
    # per-device program (launch/dryrun.py) holds a model-split slice
    d_inner, n_heads = params["w_x"].shape[-1], params["w_dt"].shape[-1]
    g, ds = s_cfg.n_groups, s_cfg.d_state
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)

    z = xc @ params["w_z"].to(cdt)
    x_in = xc @ params["w_x"].to(cdt)
    b_in = xc @ params["w_b"].to(cdt)
    c_in = xc @ params["w_c"].to(cdt)
    dt_raw = xc @ params["w_dt"].to(cdt)

    k = s_cfg.d_conv
    prev = {"x": None, "b": None, "c": None}
    if cache is not None:
        prev = {n: cache[f"conv_{n}"] for n in prev}
    conv = {}
    for n, seq in (("x", x_in), ("b", b_in), ("c", c_in)):
        conv[n] = _causal_conv(
            seq, params[f"conv_{n}_w"].to(cdt),
            params[f"conv_{n}_bias"].to(cdt), prev[n], k)

    xs = conv["x"][0].reshape(b, s, n_heads, s_cfg.head_dim)
    bmat = conv["b"][0].reshape(b, s, g, ds)
    cmat = conv["c"][0].reshape(b, s, g, ds)
    rep = n_heads // g
    bmat = torch.repeat_interleave(bmat, rep, dim=2)      # [b,s,h,ds]
    cmat = torch.repeat_interleave(cmat, rep, dim=2)
    dt = _softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])                       # [h]

    new_cache = None
    if cache is None:
        chunk = min(s_cfg.chunk, s)
        y, _final = _ssd_chunked(xs.float(), dt, a, bmat.float(),
                                 cmat.float(), chunk)
    else:
        if s > 1 and s % s_cfg.chunk == 0:
            # chunked prefill-into-state: SSD from the cached state
            y, state = _ssd_chunked(
                xs.float(), dt, a, bmat.float(), cmat.float(), s_cfg.chunk,
                init_state=cache["ssm"].float().transpose(-1, -2))
        else:
            # single-/few-step decode: the exact recurrence
            y, state = _recurrence(xs.float(), dt, a, bmat.float(),
                                   cmat.float(), cache["ssm"].float())
        new_cache = {
            f"conv_{n}": cache[f"conv_{n}"].copy_(conv[n][1])
            for n in ("x", "b", "c")
        }
        new_cache["ssm"] = cache["ssm"].copy_(state)

    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(cdt)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    y = constrain(y, ("batch", "seq", "mlp"))
    out = y @ params["w_out"].to(cdt)
    return constrain(out, ("batch", "seq", "embed")), new_cache


def _recurrence(xs, dt, a, bmat, cmat, state):
    """The exact recurrence over the ``s`` tokens, in float32: per step
    st = st · exp(dt·A) + (x·dt) ⊗ B, y = st · C.  ``state`` [b, h, dh,
    ds] is not written.  Returns y [b, s, h, dh], the final state."""
    ys = []
    for t in range(xs.shape[1]):
        dtt = dt[:, t]                                    # [b, h]
        dec = torch.exp(dtt * a[None, :])
        state = state * dec[..., None, None] + \
            (xs[:, t] * dtt[..., None])[..., None] * bmat[:, t, :, None, :]
        ys.append(torch.einsum("bhds,bhs->bhd", state, cmat[:, t]))
    return torch.stack(ys, dim=1), state


def init_mamba_cache(cfg, batch, dtype=torch.bfloat16, device=None,
                     lead: Tuple[int, ...] = ()):
    """Zeroed conv windows in ``dtype`` and a float32 SSM state [batch,
    heads, head_dim, d_state], each behind the ``lead`` axes."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    gd = s.n_groups * s.d_state
    lead = tuple(lead)
    return {
        "conv_x": torch.zeros(lead + (batch, s.d_conv - 1, d_inner),
                              dtype=dtype, device=device),
        "conv_b": torch.zeros(lead + (batch, s.d_conv - 1, gd),
                              dtype=dtype, device=device),
        "conv_c": torch.zeros(lead + (batch, s.d_conv - 1, gd),
                              dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_cache_axes():
    return {
        "conv_x": ("batch", None, "mlp"),
        "conv_b": ("batch", None, "d_state"),
        "conv_c": ("batch", None, "d_state"),
        "ssm": ("batch", "heads", None, "d_state"),
    }
