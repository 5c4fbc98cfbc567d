"""Perf hillclimb: re-run a dry-run cell under config variants and
report the three roofline terms of each over the card's peaks.

    PYTHONPATH=src python -m repro_torch.launch.perf \
        --arch smollm-360m --shape train_4k \
        --variants baseline,causal_skip

PyTorch port of ``repro.launch.perf``.  Each variant is a pure
``ModelConfig`` transform under the reference's name (the baseline is the
paper-faithful configuration), so before/after deltas are
like-for-like on the same counters (``launch/dryrun.py``).  Nothing here
touches the environment, at import or when run.
"""
import argparse
import json
from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig

VARIANTS: Dict[str, Callable[[ModelConfig], ModelConfig]] = {
    "baseline": lambda c: c,
    # compute/memory: visit only the causal triangle of kv blocks
    "causal_skip": lambda c: c.scaled(causal_skip=True),
    # memory/compute tradeoff: save matmul outputs instead of recomputing
    "remat_dots": lambda c: c.scaled(remat_policy="dots"),
    # collective: serving layout — no FSDP weight gathers, expert-TP,
    # bf16 weights
    "serve_layout": lambda c: c.scaled(
        serving=True, param_dtype="bfloat16"
    ),
    # collective: serving layout + bf16 MoE psum payloads
    "serve_layout+psum_bf16": lambda c: c.scaled(
        serving=True, param_dtype="bfloat16", moe_psum_bf16=True
    ),
    # combined training recipe
    "causal_skip+remat_dots": lambda c: c.scaled(
        causal_skip=True, remat_policy="dots"
    ),
    # training collective: bf16 MoE psum only
    "psum_bf16": lambda c: c.scaled(moe_psum_bf16=True),
    # prefill recipe: serve weight layout (no FSDP gathers) but tokens
    # stay local (train-style EP); experts replicated over data
    "serve_weights": lambda c: c.scaled(
        serving=True, param_dtype="bfloat16", serve_expert_ff_tp=False
    ),
    "serve_weights+psum_bf16": lambda c: c.scaled(
        serving=True, param_dtype="bfloat16", serve_expert_ff_tp=False,
        moe_psum_bf16=True,
    ),
    "serve_weights+psum_bf16+causal_skip": lambda c: c.scaled(
        serving=True, param_dtype="bfloat16", serve_expert_ff_tp=False,
        moe_psum_bf16=True, causal_skip=True,
    ),
    # smaller attention working set
    "causal_skip+psum_bf16": lambda c: c.scaled(
        causal_skip=True, moe_psum_bf16=True
    ),
}


def terms_of(rec: Dict) -> Dict[str, float]:
    """A record's roofline terms over the card's peaks, in seconds."""
    from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

    return {
        "compute_s": rec["flops_per_device"] / PEAK_FLOPS,
        "memory_s": rec["bytes_per_device"] / HBM_BW,
        "memory_boundary_s":
            rec.get("bytes_boundary_per_device", 0.0) / HBM_BW,
        "collective_s":
            rec["collective_bytes_per_device"]["total"] / LINK_BW,
    }


def main(argv=None):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import CARD

    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--variants", default="baseline")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    print(f"peaks: {CARD}")
    rows = []
    for name in args.variants.split(","):
        rec = run_cell(args.arch, args.shape, args.multi_pod, VARIANTS[name])
        terms = terms_of(rec)
        core = {k: terms[k] for k in
                ("compute_s", "memory_s", "collective_s")}
        dom = max(core, key=core.get)
        rows.append((name, terms, dom, rec))
        print(
            f"[{name}] compute={terms['compute_s']:.3e}s "
            f"memory={terms['memory_s']:.3e}s "
            f"memory_boundary={terms['memory_boundary_s']:.3e}s "
            f"collective={terms['collective_s']:.3e}s "
            f"dominant={dom} "
            f"temp_mem={rec['memory']['temp_size_in_bytes']/2**30:.1f}GiB",
            flush=True,
        )

    if len(rows) > 1:
        base = rows[0][1]
        for name, terms, dom, _ in rows[1:]:
            print(f"\n{name} vs {rows[0][0]}:")
            for k in terms:
                if base[k] > 0:
                    print(f"  {k}: {base[k]:.3e} → {terms[k]:.3e} "
                          f"({terms[k]/base[k]:.2%})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                [{"variant": n, "terms": t, "dominant": d,
                  "record": r} for n, t, d, r in rows],
                f, indent=1,
            )
    return rows


if __name__ == "__main__":
    main()
