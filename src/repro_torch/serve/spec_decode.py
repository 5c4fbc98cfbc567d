"""Trie-backed n-gram speculative decoding (paper Eq. 1-4 at serve time).

The NgramTrie proposes a multi-token draft whose compound confidence (the
paper's product of node Confidences) gates the draft length; the model
verifies all draft tokens in ONE decode_step (tokens [b, k+1]) and accepts
the longest matching prefix — standard draft-verification with the Trie of
rules as the (free, training-less) draft model.

Single-sequence (b=1) host loop: serving-side batching composes this per
sequence; the verification call itself is batched across the draft.
PyTorch port of ``repro.serve.spec_decode``: each verify step reads the
model's greedy tokens back to the host to compare them with the draft.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.data.corpus_rules import NgramTrie
from repro_torch.models.model import integer_leaf
from repro_torch.pytree import tree_map
from .engine import make_decode_step


def _greedy(logits: torch.Tensor) -> np.ndarray:
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


def speculative_generate(
    cfg,
    params,
    cache,
    prompt: np.ndarray,            # [1, s0]
    trie: NgramTrie,
    n_tokens: int,
    max_draft: int = 4,
    min_confidence: float = 0.3,
) -> Tuple[np.ndarray, dict]:
    """Greedy speculative decoding; returns (tokens [1, n], stats)."""
    decode = make_decode_step(cfg)
    dev = params["embed"].device

    def on_device(tokens):
        return torch.as_tensor(tokens, dtype=torch.int32, device=dev)

    # prefill the prompt (cache consumes it in one step)
    logits, cache = decode(params, cache, on_device(np.asarray(prompt)))
    last = _greedy(logits[:, -1:])[0, 0]

    out: List[int] = []
    context = [int(t) for t in prompt[0]] + [int(last)]
    proposed = accepted = steps = 0
    while len(out) < n_tokens:
        out.append(int(last))
        if len(out) >= n_tokens:
            break
        tail = tuple(context[-(trie.n - 1):])
        draft, conf = trie.propose(
            tail, max_tokens=max_draft, min_confidence=min_confidence
        )
        steps += 1
        if draft:
            proposed += len(draft)
            block = np.array(
                [[last] + list(draft)], np.int32
            )                                       # [1, k+1]
            logits, cache = decode(params, cache, on_device(block))
            preds = _greedy(logits)[0]              # model's next-token
            # accept longest prefix of draft matching the model
            n_ok = 0
            for i, d in enumerate(draft):
                if preds[i] == d:
                    n_ok += 1
                else:
                    break
            accepted += n_ok
            newly = list(draft[:n_ok]) + [int(preds[n_ok])]
            # cache now contains k+1 appended tokens; roll back the
            # rejected suffix by rewinding the cache position
            overshoot = len(draft) - n_ok
            if overshoot > 0:
                cache = _rewind(cache, overshoot)
            # accepted draft tokens are confirmed AND already in-cache:
            # emit them now; the model's own next token becomes `last`
            # (emitted at loop top, fed to the cache on the next block)
            for t in newly[:-1]:
                if len(out) < n_tokens:
                    out.append(t)
                context.append(t)
            last = newly[-1]
            context.append(int(last))
        else:
            block = np.array([[last]], np.int32)
            logits, cache = decode(params, cache, on_device(block))
            last = int(_greedy(logits[:, -1:])[0, 0])
            context.append(int(last))

    stats = {
        "proposed": proposed,
        "accepted": accepted,
        "accept_rate": accepted / proposed if proposed else 0.0,
        "verify_steps": steps,
    }
    return np.array([out[:n_tokens]], np.int32), stats


def _rewind(cache, k: int):
    """Rewind every per-layer position counter by k (rejected draft
    suffix): every integer leaf of rank 0 or 1.  Stale cache entries
    beyond the position are never attended (the causal mask is
    position-based), so no scrubbing is needed.

    NOTE: only attention/MLA caches are rewindable; SSM (Mamba) state
    and conv windows have already advanced and would need snapshotting —
    spec-decode therefore targets attention-family architectures.  On an
    SSM (or Jamba's hybrid) the port keeps the reference's behaviour: the
    float leaves stay as the verify step left them, so its output can
    differ from greedy decoding."""
    def fix(x):
        if integer_leaf(x) and x.ndim <= 1:
            return x - k
        return x

    return tree_map(fix, cache)
