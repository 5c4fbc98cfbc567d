#!/usr/bin/env python3
"""The peak bytes a gradient pass holds live, counted on meta tensors
(no device, any size, seconds on a CPU).

    PYTHONPATH=src python3 probes/remat_peak.py [--arch smollm-360m]
        [--seq 4096] [--batch 1] [--vocab N] [--causal-skip]

``train.train_step.loss_and_grads`` of the config at full width and
depth (``remat`` as the config has it) on a batch of ``--batch`` x
``--seq`` tokens, under ``launch.dryrun._LiveStorage``: the largest sum
of live storage the step allocates beyond its params and batch, as the
dry run's ``temp`` counts it, and the op that reached it.  ``--vocab``
cuts the vocabulary, so that the LM head's logits do not hide the units'
recompute; ``--causal-skip`` takes the triangle scan.  To compare two
trees, run it with each one's ``src`` on ``PYTHONPATH``.  One JSON line.
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import abstract_params
from repro_torch.train.train_step import loss_and_grads


class _Peak(dryrun._LiveStorage):
    """``_LiveStorage`` that also names the op at the peak."""

    at = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.cur >= self.peak:
            self.at = str(func)
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--causal-skip", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).scaled(causal_skip=args.causal_skip)
    if args.vocab:
        cfg = cfg.scaled(vocab_size=args.vocab)
    params, _ = abstract_params(cfg)
    tokens = torch.empty((args.batch, args.seq), dtype=torch.int32,
                         device="meta")
    mode = _Peak([params, tokens])
    with mode:
        loss_and_grads(cfg, params, {"tokens": tokens, "labels": tokens})
    line = dict(vars(args), remat=cfg.remat, peak_bytes=mode.peak,
                peak_op=mode.at)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
