"""Serving steps: prefill (populate cache, last-token logits) and decode
(one token per step against the KV cache).

PyTorch port of ``repro.serve.engine``.  Both steps are functions of
(params, cache, tokens) that run under ``torch.inference_mode()``; the
cache is consumed (its buffers are written in place, as the reference's
jitted decode donates them) and the new one is returned.  They run on the
device the parameters and cache live on.
"""
from __future__ import annotations

import torch

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
    return torch.cat(out, dim=1), cache
