"""Optimizers on parameter trees: AdamW and factored Adafactor.

PyTorch port of ``repro.train.optimizer``.  ``pick_optimizer(cfg)``
selects Adafactor for models of 100B parameters or more, so the optimizer
state stays O(sum of dims) instead of O(params).  Both optimizers expose
``init(params) → state``, ``state_axes(param_axes)`` (the state shards
like its parameters) and ``update(grads, state, params, step) →
(new_params, new_state, grad_norm)``, functional on trees
(``repro_torch.pytree``): nothing is written in place.

The arithmetic is the reference's, in float32: ``step`` becomes a float32
tensor on the parameters' device, the bias corrections are ``b ** t`` with
``t = step + 1`` a float32 tensor, the warm-up ``min(1, (step + 1) /
warmup)``, Adafactor's decay ``1 - (step + 1) ** -0.8`` with ``rsqrt``
factors and an RMS clip over the whole leaf, and the global norm sums the
leaves in ``tree_leaves`` order (the reference's leaf order).  A leaf of
two or more dimensions takes weight decay and, in Adafactor, a factored
second moment; the stacked units' norm scales (``[n_units, d]``) count as
such leaves, as in the reference.

Placed leaves (DTensors on a process mesh, each state leaf laid out like
its parameter): AdamW runs leaf by leaf on each rank's blocks (its
arithmetic is elementwise), Adafactor's row and column means and its RMS
clip run as DTensor reductions (over a split dim, the whole dim's), and
the global norm adds each leaf's block sums of squares over the mesh
dims that split it.  The new params and state keep the placements they
came in with.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.sharding import is_placed
from repro_torch.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # "adamw" | "adafactor"
    lr: float = 3e-4
    warmup_steps: int = 100
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _step_tensor(step, like: torch.Tensor) -> torch.Tensor:
    """``step`` (a number or a tensor) as a float32 scalar on ``like``'s
    device."""
    return torch.as_tensor(step, dtype=torch.float32, device=like.device)


def lr_schedule(ocfg: OptConfig, step):
    warm = torch.clamp((step + 1) / max(ocfg.warmup_steps, 1), max=1.0)
    return ocfg.lr * warm


def _square_sum(x) -> torch.Tensor:
    """The sum of squares of a whole leaf: a placed leaf's block sums
    added over the mesh dims that split it (the same on every rank)."""
    if not is_placed(x):
        return torch.sum(torch.square(x.float()))
    total = torch.sum(torch.square(x.to_local().float()))
    mesh = x.device_mesh
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return total


def global_norm(tree) -> torch.Tensor:
    leaves = [_square_sum(x) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with implicit_replication():
        return tree_map(lambda g: g * scale, grads), norm


def _blockwise(fn, p, *rest):
    """``fn`` on the local blocks of leaves laid out alike (a placed
    ``p``), each tensor it returns placed like ``p``; on whole leaves,
    ``fn`` itself."""
    if not is_placed(p):
        return fn(p, *rest)
    out = fn(p.to_local(), *(r.to_local() for r in rest))
    return tuple(DTensor.from_local(o, p.device_mesh, p.placements,
                                    run_check=False, shape=p.shape,
                                    stride=p.stride()) for o in out)


def _like(new, old):
    """``new`` laid out as ``old`` is."""
    if is_placed(old) and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def _unzip(tree, n):
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda o, i=i: o[i], tree) for i in range(n))


def _first_leaf(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
class AdamW:
    def __init__(self, ocfg: OptConfig):
        self.cfg = ocfg

    def init(self, params):
        def zeros(p):
            if is_placed(p):
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def state_axes(self, param_axes):
        return {"m": param_axes, "v": param_axes}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        c = self.cfg
        step = _step_tensor(step, _first_leaf(params))
        grads, gnorm = clip_by_global_norm(grads, c.clip_norm)
        lr = lr_schedule(c, step)
        t = step + 1
        bc1 = 1.0 - c.b1 ** t
        bc2 = 1.0 - c.b2 ** t

        def upd(p, g, m, v):
            g = g.float()
            m = c.b1 * m + (1 - c.b1) * g
            v = c.b2 * v + (1 - c.b2) * g * g
            mh = m / bc1
            vh = v / bc2
            step_ = mh / (torch.sqrt(vh) + c.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                step_ = step_ + c.weight_decay * p.float()
            return (p.float() - lr * step_).to(p.dtype), m, v

        out = tree_map(lambda p, g, m, v: _blockwise(upd, p, _like(g, p),
                                                     m, v),
                       params, grads, state["m"], state["v"])
        new_params, new_m, new_v = _unzip(out, 3)
        return new_params, {"m": new_m, "v": new_v}, gnorm


# ----------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ----------------------------------------------------------------------
class Adafactor:
    def __init__(self, ocfg: OptConfig):
        self.cfg = ocfg

    def _factored(self, p) -> bool:
        return p.ndim >= 2

    def init(self, params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if self._factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"f": tree_map(st, params)}

    def state_axes(self, param_axes):
        def ax(axes):
            axes = tuple(axes)
            if len(axes) >= 2:
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}

        return {"f": tree_map(ax, param_axes)}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        c = self.cfg
        step = _step_tensor(step, _first_leaf(params))
        grads, gnorm = clip_by_global_norm(grads, c.clip_norm)
        lr = lr_schedule(c, step)
        beta = 1.0 - (step + 1.0) ** -0.8   # t^-0.8 decay (Adafactor paper)

        def upd(p, g, st):
            g = g.float()
            g2 = g * g + 1e-30
            if self._factored(p):
                vr = beta * st["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * st["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                     min=1e-30) + c.eps)
                cfac = torch.rsqrt(vc + c.eps)
                step_ = g * rfac[..., None] * cfac[..., None, :]
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                step_ = g * torch.rsqrt(v + c.eps)
                new_st = {"v": v}
            # RMS-clip the update (Adafactor d=1.0)
            rms = torch.sqrt(torch.mean(step_ * step_) + 1e-30)
            step_ = step_ / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                step_ = step_ + c.weight_decay * p.float()
            return (p.float() - lr * step_).to(p.dtype), new_st

        def placed_upd(p, g, st):
            with implicit_replication():
                new_p, new_st = upd(p, g, st)
            return _like(new_p, p), {k: _like(v, st[k])
                                     for k, v in new_st.items()}

        out = tree_map(placed_upd, params, grads, state["f"])
        new_params, new_f = _unzip(out, 2)
        return new_params, {"f": new_f}, gnorm


def pick_optimizer(model_cfg, ocfg: Optional[OptConfig] = None):
    """Adafactor at ≥100B params, AdamW below (overridable)."""
    if ocfg is None:
        ocfg = OptConfig()
    if ocfg.name == "adafactor":
        return Adafactor(ocfg)
    if ocfg.name == "adamw":
        from repro_torch.models import count_params_analytic

        if count_params_analytic(model_cfg) >= 100e9:
            return Adafactor(dataclasses.replace(ocfg, name="adafactor"))
        return AdamW(ocfg)
    raise ValueError(ocfg.name)
