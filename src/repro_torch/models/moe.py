"""Mixture-of-Experts FFN (DeepSeek-style shared + routed experts).

PyTorch port of ``repro.models.moe``.  Three implementations, as in the
reference:

- ``moe_dense``     every expert on every token, gated by the router's
                    probabilities.  Exact (no capacity drops); what one
                    device serves, and the oracle of the other two.
- ``moe_alltoall``  the reference's expert parallelism: experts split over
                    the mesh's ``model`` axis; each slice sorts the token
                    copies routed to its experts by expert id (stable),
                    packs them into per-expert capacity buffers (a copy
                    past the capacity goes to a dustbin slot and is
                    dropped), runs its experts as dense [E_local, cap, d]
                    products and scatters the gated outputs back; the
                    slices' partial outputs are summed (the reference's
                    ``psum`` over ``model``).
- ``moe_serve_tp``  the reference's serving layout of the same dispatch
                    (expert FFN hidden split over ``data``).

The expert-parallel paths read the ambient mesh
(``distributed.sharding.get_mesh``).  Without one, or without a ``model``
axis, they run ``moe_dense``, as the reference does off a mesh.  With a
``model`` extent ``ep`` they run the reference's shard body once per
expert slice (``e_local = n_routed // ep``, ``lo = slice * e_local``), one
slice after another on the tensors' device, and add the slices' outputs in
slice order (in bf16 when ``cfg.moe_psum_bf16`` is set).  The capacity,
the stable sort, the group starts and the drops are the reference's, so
which token copies are dropped does not depend on ``ep``.  A ``data`` or
``pod`` extent above 1, or a mesh over several devices, raises: that is
the multi-GPU LM slice.

On meta tensors (the dry run's per-device program, ``launch/dryrun.py``)
the expert-parallel paths run one device's work under any mesh: the
router over every expert, then one slice of ``e_local`` experts (the
params hold that slice) at the capacity of the tokens the device holds
(the serving layout: of the tokens all-gathered over the batch axes).

Router: softmax → top-k (ties to the lower expert index, as
``lax.top_k``: a stable descending sort), probabilities renormalized over
the selected experts, plus the load-balance auxiliary loss.  On the card
the scatter-add of the dispatch path uses atomics, so it is held to a
tolerance there, never bitwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import MULTI_GPU, constrain, get_mesh
from .layers import pv, torch_dtype


def init_moe(key, cfg, lead: Tuple[int, ...] = ()):
    """Draws, in order: ``router``, ``wi``, ``wg``, ``wo``, then (with
    shared experts) ``shared_wi``, ``shared_wg``, ``shared_wo``."""
    mo = cfg.moe
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": pv(key, "router", (d, mo.n_routed), (None, "expert"),
                     torch.float32, lead=lead),
        "wi": pv(key, "moe_wi", (mo.n_routed, d, mo.d_expert),
                 ("expert", "fsdp", "expert_ff"), dt, lead=lead),
        "wg": pv(key, "moe_wg", (mo.n_routed, d, mo.d_expert),
                 ("expert", "fsdp", "expert_ff"), dt, lead=lead),
        "wo": pv(key, "moe_wo", (mo.n_routed, mo.d_expert, d),
                 ("expert", "expert_ff", "fsdp"), dt, fan_in=mo.d_expert,
                 lead=lead),
    }
    if mo.n_shared:
        f = mo.d_expert * mo.n_shared
        p["shared_wi"] = pv(key, "shared_wi", (d, f), ("fsdp", "mlp"), dt,
                            lead=lead)
        p["shared_wg"] = pv(key, "shared_wg", (d, f), ("fsdp", "mlp"), dt,
                            lead=lead)
        p["shared_wo"] = pv(key, "shared_wo", (f, d), ("mlp", "fsdp"), dt,
                            fan_in=mo.d_expert, lead=lead)
    return p


def top_k_lower_first(x, k):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg, params, x2d):
    """x2d: [T, d] → (probs [T, k], ids [T, k], aux_loss scalar)."""
    mo = cfg.moe
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lower_first(probs, mo.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch): E * Σ_e f_e · P_e
    pe = probs.mean(0)
    fe = F.one_hot(top_i, mo.n_routed).float().sum(1).mean(0)
    aux = mo.n_routed * torch.sum(pe * fe)
    return top_p, top_i, aux


def _expert_ffn(cdt, wi, wg, wo, x):
    """x: [E, C, d] dense per-expert SwiGLU."""
    h = torch.bmm(x, wi.to(cdt))
    g = torch.bmm(x, wg.to(cdt))
    return torch.bmm(F.silu(g) * h, wo.to(cdt))


def _shared_ffn(cfg, params, xc, cdt):
    h = xc @ params["shared_wi"].to(cdt)
    g = xc @ params["shared_wg"].to(cdt)
    h = F.silu(g) * h
    h = constrain(h, ("batch", "seq", "mlp"))
    return h @ params["shared_wo"].to(cdt)


# ----------------------------------------------------------------------
# dense (exact) implementation
# ----------------------------------------------------------------------
def moe_dense(cfg, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    b, s, d = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    x2d = xc.reshape(-1, d)
    top_p, top_i, aux = _router(cfg, params, x2d)
    gates = (F.one_hot(top_i, mo.n_routed).float()
             * top_p[..., None]).sum(1)                      # [T, E]
    # every expert on every token, expert-major: [E, T, f]
    h = torch.matmul(x2d, params["wi"].to(cdt))
    g = torch.matmul(x2d, params["wg"].to(cdt))
    o = torch.bmm(F.silu(g) * h, params["wo"].to(cdt))        # [E, T, d]
    y = torch.bmm(gates[:, None, :], o.float().transpose(0, 1))[:, 0]
    y = y.reshape(b, s, d).to(x.dtype)
    if mo.n_shared:
        y = y + _shared_ffn(cfg, params, xc, cdt).to(x.dtype)
    return y, aux


# ----------------------------------------------------------------------
# expert-parallel implementations, read for one process
# ----------------------------------------------------------------------
def _capacity(n_tokens: int, cfg) -> int:
    mo = cfg.moe
    cap = int(n_tokens * mo.top_k * mo.capacity_factor / mo.n_routed)
    return max(8, -(-cap // 8) * 8)


def _extent(mesh, axes) -> int:
    e = 1
    for a in axes:
        e *= mesh.shape[a]
    return e


def _one_process(mesh, axes):
    """Raise unless the mesh's ``axes`` (the data-parallel ones) all have
    extent 1 and it names at most one device."""
    wide = {a: mesh.shape[a] for a in axes
            if a in mesh.shape and mesh.shape[a] > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} split tokens or expert FFNs over several "
            f"devices; the port runs one device: {MULTI_GPU}")
    devices = getattr(mesh, "devices", None)
    names = set() if devices is None else {
        str(v) for v in np.asarray(devices, dtype=object).reshape(-1)}
    if len(names) > 1:
        raise NotImplementedError(
            f"a mesh over the devices {sorted(names)} places expert slices "
            f"on several GPUs: {MULTI_GPU}")


def _slice_dispatch(cfg, params, x2d, top_p, top_i, lo, e_local, cap, cdt):
    """One expert slice of the reference's shard body: the token copies
    routed to experts ``[lo, lo + e_local)``, sorted by expert (stable),
    packed into ``cap`` slots an expert (the rest to the dustbin slot),
    run through the slice's experts and scattered back, gated, into a
    float32 [T, d]."""
    mo = cfg.moe
    t, d = x2d.shape
    dev = x2d.device
    flat_e = top_i.reshape(-1)                           # [T*k]
    flat_w = top_p.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(mo.top_k)
    local = (flat_e >= lo) & (flat_e < lo + e_local)
    leid = torch.where(local, flat_e - lo, e_local)     # dustbin = E_l
    order = torch.sort(leid, stable=True).indices
    s_eid, s_tok, s_w = leid[order], flat_t[order], flat_w[order]
    # position within the expert group
    starts = torch.searchsorted(
        s_eid, torch.arange(e_local + 1, device=dev, dtype=s_eid.dtype))
    pos_in_e = torch.arange(s_eid.shape[0], device=dev) - starts[
        torch.clamp(s_eid, 0, e_local)]
    keep = (s_eid < e_local) & (pos_in_e < cap)
    slot = torch.where(keep, s_eid * cap + pos_in_e, e_local * cap)
    buf = torch.zeros((e_local * cap + 1, d), dtype=cdt, device=dev)
    buf[slot] = torch.where(keep[:, None], x2d[s_tok], 0.0).to(cdt)
    eb = buf[: e_local * cap].reshape(e_local, cap, d)
    hi = lo + e_local
    out = _expert_ffn(cdt, params["wi"][lo:hi], params["wg"][lo:hi],
                      params["wo"][lo:hi], eb)           # [E_l, cap, d]
    out_flat = out.reshape(e_local * cap, d)
    gathered = torch.where(
        keep[:, None], out_flat[torch.clamp(slot, 0, e_local * cap - 1)],
        0.0)
    y2d = torch.zeros((t, d), dtype=torch.float32, device=dev)
    return y2d.index_add_(0, s_tok, gathered.float() * s_w[:, None])


def _routed(cfg, params, x, ep, cap, slices):
    """The shard body over the first ``slices`` of ``ep`` expert slices
    on this device: the slices' outputs summed in slice order (the
    ``psum``), the router's aux averaged over the ``ep`` slices (the
    ``pmean``)."""
    b, s, d = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    x2d = x.to(cdt).reshape(-1, d)
    top_p, top_i, aux = _router(cfg, params, x2d)
    e_local = cfg.moe.n_routed // ep
    y2d = None
    for my in range(slices):
        part = _slice_dispatch(cfg, params, x2d, top_p, top_i,
                               my * e_local, e_local, cap, cdt)
        if cfg.moe_psum_bf16:   # the reference's bf16 psum payload
            part = part.to(torch.bfloat16)
        y2d = part if y2d is None else y2d + part
    aux = torch.stack([aux] * ep).mean()
    return y2d.float().reshape(b, s, d).to(x.dtype), aux


def _with_shared(cfg, params, x, y):
    if cfg.moe.n_shared:
        cdt = torch_dtype(cfg.compute_dtype)
        y = y + _shared_ffn(cfg, params, x.to(cdt), cdt).to(x.dtype)
    return y


def _dispatch(cfg, params, x, ep, cap):
    """The shard body over all ``ep`` expert slices on this device, plus
    the shared experts; on meta tensors one device's slice
    (``slices=1``: the params hold that slice)."""
    slices = 1 if x.device.type == "meta" else ep
    y, aux = _routed(cfg, params, x, ep, cap, slices)
    return _with_shared(cfg, params, x, y), aux


def moe_alltoall(cfg, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the ambient mesh's ``model`` axis."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.shape:
        return moe_dense(cfg, params, x)
    mo = cfg.moe
    b, s, _ = x.shape
    ep = mesh.shape["model"]
    if mo.n_routed % ep != 0:
        return moe_dense(cfg, params, x)
    if x.device.type != "meta":
        _one_process(mesh, ("pod", "data"))
    return _dispatch(cfg, params, x, ep, _capacity(b * s, cfg))


def moe_serve_tp(cfg, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving layout: experts over ``model``, expert FFN hidden over
    ``data`` (extent 1 here), the capacity from the global token count."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.shape:
        return moe_dense(cfg, params, x)
    mo = cfg.moe
    b, s, _ = x.shape
    ep = mesh.shape["model"]
    ff_axes = tuple(a for a in ("data",) if a in mesh.shape)
    if mo.n_routed % ep != 0 or (
        ff_axes and mo.d_expert % _extent(mesh, ff_axes) != 0
    ):
        return moe_alltoall(cfg, params, x)
    if x.device.type == "meta":
        # one device's work: its tokens all-gathered over the shards its
        # layout cut the batch into (the dry run's mesh says how many),
        # its experts' FFN slice over them, its own rows back
        n = getattr(mesh, "token_shards", 1)
        x_all = x.repeat(n, 1, 1)
        y, aux = _routed(cfg, params, x_all, ep, _capacity(n * b * s, cfg),
                         1)
        return _with_shared(cfg, params, x, y[:b]), aux
    _one_process(mesh, ("pod", "data"))
    return _dispatch(cfg, params, x, ep, _capacity(b * s, cfg))


def moe(cfg, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.serving and cfg.moe.impl != "dense" and cfg.serve_expert_ff_tp:
        return moe_serve_tp(cfg, params, x)
    if cfg.moe.impl == "alltoall":
        return moe_alltoall(cfg, params, x)
    return moe_dense(cfg, params, x)
