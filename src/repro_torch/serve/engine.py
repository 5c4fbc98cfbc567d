"""Serving steps: prefill (populate cache, last-token logits) and decode
(one token per step against the KV/SSM cache).

PyTorch port of ``repro.serve.engine``.  Both steps are functions of
(params, cache, tokens) that run under ``torch.inference_mode()``; the
cache is consumed (its buffers are written in place, as the reference's
jitted decode donates them) and the new one is returned.  They run on the
device the parameters and cache live on.  On a process mesh (params and
cache placed by ``train.elastic.remesh_state``, the cache by
``models.cache_axes``) every rank runs them on its rows; the logits and
tokens come back placed, and each rank's block of the cache is written
in place.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import is_placed
from repro_torch.models import forward
from repro_torch.models.model import decode_step


def make_prefill_step(cfg):
    def prefill(params, cache, batch):
        with torch.inference_mode():
            logits, _extras, new_cache = forward(
                cfg, params, batch, cache=cache, logits_mode="last"
            )
        return logits, new_cache

    return prefill


def make_decode_step(cfg):
    def decode(params, cache, tokens):
        with torch.inference_mode():
            return decode_step(cfg, params, cache, tokens)

    return decode


def _next_token(logits):
    """The greedy token of each row's last position; placed logits give
    placed tokens (each rank's rows)."""
    if is_placed(logits):
        return DTensor.from_local(_next_token(logits.to_local()),
                                  logits.device_mesh, logits.placements,
                                  run_check=False)
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


def greedy_generate(cfg, params, cache, prompt_tokens, n_steps: int):
    """Prefill the prompt then greedy-decode ``n_steps`` tokens; the loop
    stays on the device (no host read until the caller reads the
    tokens).  Returns (tokens [b, n_steps] int32, cache)."""
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt_tokens, dtype=torch.int32, device=dev)
    logits, cache = prefill(params, cache, {"tokens": prompt})
    out = []
    tok = _next_token(logits)
    for _ in range(n_steps):
        out.append(tok)
        logits, cache = decode(params, cache, tok)
        tok = _next_token(logits)
    if out and is_placed(out[0]):
        return DTensor.from_local(torch.cat([t.to_local() for t in out], 1),
                                  tok.device_mesh, tok.placements,
                                  run_check=False), cache
    return torch.cat(out, dim=1), cache
