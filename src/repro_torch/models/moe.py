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
axis, they run ``moe_dense``, as the reference does off a mesh.

On a process mesh (``launch.mesh.ProcessMesh``, one process a device)
each rank runs the reference's shard body on its own expert slice
(``e_local = n_routed // ep``, ``lo = coord("model") * e_local``) with
the router whole on every rank: its rows (split over the batch axes
where the batch divides, as the reference's ``bspec``), its experts'
weights (``local_block`` of the placed leaves: the ``fsdp`` dim
gathered, the expert dim kept), then the reference's collectives over
the axes' process groups: the ``psum`` of the partial outputs over
``model`` (and ``data`` for ``serve_tp``; in bf16 when
``cfg.moe_psum_bf16``), the ``pmean`` of the aux loss over ``model`` and
the batch axes, and for ``serve_tp`` the ``all_gather`` of the tokens
over the batch axes and the slice of the rank's rows back (in the
global row order: on a mesh with ``pod`` and ``data`` above 1 the
reference gathers the rows data-major and slices them pod-major, and
hands two of every four ranks other rows; the port does not).  Gradients:
the router's and the routed input's are summed over the ranks whose
slices each add a part (``sum_grads``), the expert blocks' over the
ranks that saw other rows.

On a mesh of one process (anything else with a ``.shape``: the mesh's
ranks are this device) the same bodies run in series: for each block of
rows, the ``ep`` expert slices one after another, their outputs added in
slice order (each rounded to bf16 and the sum rounded once when
``cfg.moe_psum_bf16`` is set, as XLA sums a bf16 ``psum``; the serving
layout's FFN blocks over ``data`` each a part).  The capacity,
the stable sort, the group starts and the drops are the reference's, so
which token copies are dropped does not depend on ``ep``.  Such a mesh
naming several devices raises ``ValueError``: several devices take a
process mesh.

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
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    Rows,
    constrain,
    get_mesh,
    is_placed,
    local_block,
    placements_of,
    pmean,
    psum,
    sum_grads,
    all_gather_rows,
)
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


def _router(cfg, params, x2d, rows=None):
    """x2d: [T, d] → (probs [T, k], ids [T, k], aux_loss scalar).  With
    ``rows`` (a process mesh's rows: ``x2d`` is this rank's tokens) the
    aux loss's means run over every rank's tokens, as the reference's
    over the global batch."""
    mo = cfg.moe
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lower_first(probs, mo.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch): E * Σ_e f_e · P_e
    picks = F.one_hot(top_i, mo.n_routed).float().sum(1)
    if rows is not None and rows.count > 1:
        t = x2d.shape[0] * rows.count
        pe = rows.sum(probs.sum(0)) / t
        fe = rows.sum(picks.sum(0)) / t
    else:
        pe = probs.mean(0)
        fe = picks.mean(0)
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
def moe_dense(cfg, params, x, rows=None) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Every expert on every token.  With ``rows`` (a placed model's
    step: ``x`` is this rank's rows) the placed weights are taken whole
    and the aux loss is the global batch's."""
    if rows is not None:
        params = rows.tree(params)
    mo = cfg.moe
    b, s, d = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    x2d = xc.reshape(-1, d)
    top_p, top_i, aux = _router(cfg, params, x2d, rows)
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


def _batch_axes(mesh, b) -> Tuple[str, ...]:
    """The reference's batch axes: ``pod`` and ``data`` where the mesh
    has them and their product divides the (global) batch ``b``, else
    none."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return dp if dp and b % _extent(mesh, dp) == 0 else ()


def _one_device(mesh):
    """Raise unless a mesh of one process names at most one device."""
    devices = getattr(mesh, "devices", None)
    names = set() if devices is None else {
        str(v) for v in np.asarray(devices, dtype=object).reshape(-1)}
    if len(names) > 1:
        raise ValueError(
            f"a mesh over the devices {sorted(names)} in one process: "
            "several devices take a process mesh (launch.mesh.make_mesh, "
            "one process a device)")


def _slice_dispatch(cfg, w, x2d, top_p, top_i, lo, e_local, cap, cdt):
    """One expert slice of the reference's shard body: the token copies
    routed to experts ``[lo, lo + e_local)``, sorted by expert (stable),
    packed into ``cap`` slots an expert (the rest to the dustbin slot),
    run through the slice's experts (``w``: ``wi``, ``wg``, ``wo`` of
    those ``e_local`` experts) and scattered back, gated, into a float32
    [T, d]."""
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
    out = _expert_ffn(cdt, w["wi"], w["wg"], w["wo"], eb)  # [E_l, cap, d]
    out_flat = out.reshape(e_local * cap, d)
    gathered = torch.where(
        keep[:, None], out_flat[torch.clamp(slot, 0, e_local * cap - 1)],
        0.0)
    y2d = torch.zeros((t, d), dtype=torch.float32, device=dev)
    return y2d.index_add_(0, s_tok, gathered.float() * s_w[:, None])


# each expert leaf's FFN-hidden dim (the serving layout splits it over
# ``data``)
_FF_DIM = {"wi": 2, "wg": 2, "wo": 1}


def _routed(cfg, params, x, ep, cap, slices, ff=1):
    """The shard body over the first ``slices`` of ``ep`` expert slices
    (each cut into ``ff`` blocks of its FFN hidden dim, the serving
    layout's split over ``data``) on this device: the parts summed in
    order (the ``psum``), the router's aux averaged over the ``ep``
    slices (the ``pmean``).  With ``cfg.moe_psum_bf16`` each part is
    rounded to bf16 and the float32 sum rounded once more, as XLA sums a
    bf16 ``psum``."""
    b, s, d = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    x2d = x.to(cdt).reshape(-1, d)
    top_p, top_i, aux = _router(cfg, params, x2d)
    e_local = cfg.moe.n_routed // ep
    y2d = None
    for my in range(slices):
        lo = my * e_local
        for j in range(ff):
            w = {k: params[k][lo:lo + e_local] for k in _FF_DIM}
            w = {k: v.chunk(ff, _FF_DIM[k])[j] for k, v in w.items()}
            part = _slice_dispatch(cfg, w, x2d, top_p, top_i, lo, e_local,
                                   cap, cdt)
            if cfg.moe_psum_bf16:   # the reference's bf16 psum payload
                part = part.to(torch.bfloat16).float()
            y2d = part if y2d is None else y2d + part
    if cfg.moe_psum_bf16:
        y2d = y2d.to(torch.bfloat16).float()
    aux = torch.stack([aux] * ep).mean()
    return y2d.reshape(b, s, d).to(x.dtype), aux


def _with_shared(cfg, params, x, y):
    if cfg.moe.n_shared:
        cdt = torch_dtype(cfg.compute_dtype)
        y = y + _shared_ffn(cfg, params, x.to(cdt), cdt).to(x.dtype)
    return y


def _dispatch(cfg, params, x, ep, cap, ff=1):
    """The shard body over all ``ep`` expert slices (and ``ff`` FFN
    blocks) on this device, plus the shared experts; on meta tensors one
    device's slice (``slices=1``: the params hold that slice)."""
    slices = 1 if x.device.type == "meta" else ep
    y, aux = _routed(cfg, params, x, ep, cap, slices, ff)
    return _with_shared(cfg, params, x, y), aux


def _in_series(cfg, params, x, mesh, ep, serve):
    """The one-process path: the rows cut into the reference's batch
    blocks (``alltoall``; ``serve_tp`` all-gathers them, so runs one
    block of every row at the global capacity), each block's ``ep``
    slices in series; the aux loss averaged over the blocks."""
    _one_device(mesh)
    b, s, _ = x.shape
    n = 1 if serve else _extent(mesh, _batch_axes(mesh, b))
    ff = mesh.shape.get("data", 1) if serve else 1
    blocks = [_dispatch(cfg, params, xb, ep, _capacity(xb.shape[0] * s, cfg),
                        ff)
              for xb in x.chunk(n, 0)]
    if n == 1:
        return blocks[0]
    return (torch.cat([y for y, _ in blocks], 0),
            torch.stack([a for _, a in blocks]).mean())


def _rows_of(x, mesh, rows):
    """(this rank's rows of ``x`` as a plain tensor, their ``Rows``, and
    how to give an output back in ``x``'s form): a DTensor's rows are its
    own block (split over the mesh axes its dim 0 is sharded over);
    a plain ``x`` is this rank's rows under ``rows``, or, without, the
    whole batch on every rank."""
    if is_placed(x):
        placements = x.placements

        def back(y):
            return DTensor.from_local(y, mesh.device_mesh, placements,
                                      run_check=False)

        return x.to_local(), Rows.of(x, mesh), back
    return x, rows if rows is not None else Rows(mesh, ()), lambda y: y


def _regroup(x, mesh, have, want):
    """``x`` (this rank's rows, split over the axes ``have``) split over
    ``want`` instead: a DTensor redistribution of dim 0, gradients
    included."""
    if tuple(have) == tuple(want):
        return x

    def spec(axes):
        return (tuple(axes) or None,) + (None,) * (x.ndim - 1)

    dt = DTensor.from_local(x, mesh.device_mesh,
                            placements_of(spec(have), mesh), run_check=False)
    return local_block(dt, mesh, spec(want))


def _expert_block(w, mesh, spec, lo, e_local, partial=()):
    """A rank's block of an expert leaf under the shard body's
    ``in_spec``: a placed leaf's ``local_block``; a whole leaf's slice of
    experts ``[lo, lo + e_local)`` (cut along the ``data`` split of its
    FFN dim where ``spec`` names one)."""
    if is_placed(w):
        return local_block(w, mesh, spec, partial)
    w = w[lo:lo + e_local]
    for d, entry in enumerate(spec[1:], 1):
        if entry is not None and mesh.shape[entry] > 1:
            n = w.shape[d] // mesh.shape[entry]
            w = w.narrow(d, mesh.coordinate[entry] * n, n)
    return w


def _ranks_body(cfg, params, x, mesh, rows, serve):
    """The reference's shard body on this rank (see the module
    docstring); ``x`` is a DTensor, this rank's rows under ``rows``, or
    the whole batch."""
    mo = cfg.moe
    cdt = torch_dtype(cfg.compute_dtype)
    ep = mesh.shape["model"]
    e_local = mo.n_routed // ep
    lo = mesh.coordinate["model"] * e_local
    x_in, rows, back = _rows_of(x, mesh, rows)
    b_glob = x_in.shape[0] * rows.count
    batch_axes = _batch_axes(mesh, b_glob)
    xl = _regroup(x_in, mesh, rows.axes, batch_axes)
    bl, s, d = xl.shape
    ff_axes = tuple(a for a in ("data",) if a in mesh.shape) if serve else ()
    ff = ff_axes[0] if ff_axes else None
    specs = {"wi": ("model", None, ff), "wg": ("model", None, ff),
             "wo": ("model", ff, None)}
    if serve:
        # tokens all-gathered: every block of the leaf sees every row
        w = {k: _expert_block(params[k], mesh, specs[k], lo, e_local)
             for k in specs}
        # gathered over the last batch axis first: the rows come in the
        # global (pod-major) order the slice below takes its own from (the
        # reference gathers over pod first, ROADMAP.md Queue 3)
        x_all = all_gather_rows(xl, mesh, batch_axes[::-1])
        cap = _capacity(b_glob * s, cfg)
        sliced = ("model",) + tuple(a for a in ff_axes if a not in batch_axes)
    else:
        w = {k: _expert_block(params[k], mesh, specs[k], lo, e_local,
                              partial=batch_axes) for k in specs}
        x_all = xl
        cap = _capacity(bl * s, cfg)
        sliced = ("model",)
    # the router whole on every rank; its gradient, like the routed
    # input's, is a sum of the parts each rank's slice adds
    router = local_block(params["router"], mesh, None,
                         partial=tuple(mesh.axis_names))
    x2d = sum_grads(x_all.to(cdt).reshape(-1, d), mesh, sliced)
    top_p, top_i, aux = _router(cfg, {"router": router}, x2d)
    y2d = _slice_dispatch(cfg, w, x2d, top_p, top_i, lo, e_local, cap, cdt)
    psum_axes = ("model",) + ff_axes
    if cfg.moe_psum_bf16:
        # the reference's bf16 psum: XLA adds the bf16 parts in float32
        # and rounds the sum once (so float32 on the wire here)
        y2d = psum(y2d.to(torch.bfloat16).float(), mesh, psum_axes).to(
            torch.bfloat16).float()
    else:
        y2d = psum(y2d, mesh, psum_axes)
    aux = pmean(aux, mesh, ("model",))
    if batch_axes:
        aux = pmean(aux, mesh, batch_axes)
    if serve and batch_axes:
        # this shard's rows back out (the reference's index: the last
        # batch axis fastest); the rows' gradients meet over the batch
        di = mesh.coordinate[batch_axes[-1]]
        if len(batch_axes) == 2:
            di = di + mesh.coordinate[batch_axes[0]] * \
                mesh.shape[batch_axes[-1]]
        y3d = sum_grads(y2d, mesh, batch_axes).reshape(-1, s, d)
        y = y3d[di * bl:(di + 1) * bl]
    else:
        y = y2d.reshape(bl, s, d)
    y = _regroup(y.to(x_in.dtype), mesh, batch_axes, rows.axes)
    shared = {k: rows.weight(v) for k, v in params.items()
              if k.startswith("shared_")}
    return back(_with_shared(cfg, shared, x_in, y)), aux


def _process_mesh(mesh) -> bool:
    return hasattr(mesh, "device_mesh")


def moe_alltoall(cfg, params, x, rows=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the ambient mesh's ``model`` axis (the
    process mesh of ``rows`` in a placed model's step)."""
    mesh = rows.mesh if rows is not None else get_mesh()
    if mesh is None or "model" not in mesh.shape:
        return moe_dense(cfg, params, x, rows)
    mo = cfg.moe
    b, s, _ = x.shape
    ep = mesh.shape["model"]
    if mo.n_routed % ep != 0:
        return moe_dense(cfg, params, x, rows)
    if x.device.type == "meta":
        return _dispatch(cfg, params, x, ep, _capacity(b * s, cfg))
    if _process_mesh(mesh):
        return _ranks_body(cfg, params, x, mesh, rows, serve=False)
    return _in_series(cfg, params, x, mesh, ep, serve=False)


def moe_serve_tp(cfg, params, x, rows=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving layout: experts over ``model``, expert FFN hidden over
    ``data``, the tokens all-gathered over the batch axes and the
    capacity from the global token count."""
    mesh = rows.mesh if rows is not None else get_mesh()
    if mesh is None or "model" not in mesh.shape:
        return moe_dense(cfg, params, x, rows)
    mo = cfg.moe
    b, s, _ = x.shape
    ep = mesh.shape["model"]
    ff_axes = tuple(a for a in ("data",) if a in mesh.shape)
    if mo.n_routed % ep != 0 or (
        ff_axes and mo.d_expert % _extent(mesh, ff_axes) != 0
    ):
        return moe_alltoall(cfg, params, x, rows)
    if x.device.type == "meta":
        # one device's work: its tokens all-gathered over the shards its
        # layout cut the batch into (the dry run's mesh says how many),
        # its experts' FFN slice over them, its own rows back
        n = getattr(mesh, "token_shards", 1)
        x_all = x.repeat(n, 1, 1)
        y, aux = _routed(cfg, params, x_all, ep, _capacity(n * b * s, cfg),
                         1)
        return _with_shared(cfg, params, x, y[:b]), aux
    if _process_mesh(mesh):
        return _ranks_body(cfg, params, x, mesh, rows, serve=True)
    return _in_series(cfg, params, x, mesh, ep, serve=True)


def moe(cfg, params, x, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's choice of path; ``rows``: a placed model's step
    on a process mesh (``models.model.forward``)."""
    if cfg.serving and cfg.moe.impl != "dense" and cfg.serve_expert_ff_tp:
        return moe_serve_tp(cfg, params, x, rows)
    if cfg.moe.impl == "alltoall":
        return moe_alltoall(cfg, params, x, rows)
    return moe_dense(cfg, params, x, rows)
