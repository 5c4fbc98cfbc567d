"""Train-step factory: grads (+ optional microbatch accumulation) →
clip → optimizer → new params.

PyTorch port of ``repro.train.train_step``.  The step works on parameter
trees, not on ``DecoderLM`` (whose parameters are frozen): each leaf is
detached and set to require a gradient, ``loss_fn`` runs under autograd
and ``torch.autograd.grad`` returns one gradient a leaf (zeros, in the
leaf's dtype, for a leaf the loss does not reach, as ``jax.grad`` gives).
Microbatches are a loop over the leading split ``(mb, b // mb)`` of the
batch, where the reference scans: the float32 gradients are summed and
divided by ``mb``, the loss and each metric averaged.  Params and batches
must not be inference tensors (made under ``torch.inference_mode``, as
the serving engine runs): autograd refuses them.  Placed params
(DTensors on a process mesh) get placed gradients, laid out like their
leaves (a gradient that comes back partial over some ranks is summed).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import loss_fn
from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten
from .optimizer import _like


def loss_and_grads(cfg, params, batch):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (a tree of the same structure), all
    detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p)
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(
    cfg,
    optimizer,
    microbatches: int = 1,
    grad_transform: Optional[Callable] = None,
):
    """Returns step(params, opt_state, batch, step_idx) → (params,
    opt_state, metrics).  ``grad_transform`` hooks gradient compression."""

    def step(params, opt_state, batch, step_idx):
        if microbatches > 1:
            def split(x):
                b = x.shape[0]
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            stack = []
            for i in range(microbatches):
                loss, metrics, grads = loss_and_grads(
                    cfg, params, {k: v[i] for k, v in mb.items()})
                gsum = tree_map(torch.add, gsum, grads)
                lsum = lsum + loss
                stack.append(metrics)
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {k: torch.mean(torch.stack([m[k] for m in stack]),
                                     dim=0) for k in stack[0]}
        else:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)

        if grad_transform is not None:
            grads = grad_transform(grads)

        params, opt_state, gnorm = optimizer.update(
            grads, opt_state, params, step_idx
        )
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step
