"""The readings that ``check.LIMITS`` are set from, at a cell's own size.

    python3 trie_bench/readings.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>] [--faults]

For each seed, one run of the cell as ``run.py`` makes it (the program's
set-up, window and comparison, in this one process so that the runs share
the start-up), then the control (``control.py``: the reference in the
program's place, in bfloat16) on every query that run answered, and with
``--faults`` a run with each of ``faults.py``'s faults planted.  Prints one
JSON line per reading: ``{"seed", "side", "numbers"}`` with ``side`` one of
``program``, ``control`` or a fault's name.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trie_bench import control, faults, run  # noqa: E402


def emit(seed, side, numbers):
    print(json.dumps({"seed": seed, "side": side,
                      "numbers": {k: float(v) for k, v in numbers.items()}}),
          flush=True)


def main(argv=None, device=None, root=None) -> int:
    """``device`` and ``root`` as ``run.main`` takes them, for the
    benchmark's own tests."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    from trie_bench import spec

    seconds = args.seconds or spec.cell(args.workload,
                                        root or spec.ROOT)["run_seconds"]
    sides = ["program"] + (sorted(faults.ENGINE_FAULTS)
                           + sorted(faults.TRIE_FAULTS) if args.faults
                           else [])
    for seed in args.seeds:
        for side in sides:
            got = {}

            def judged(r, side=side, got=got):
                got["program"] = r.numbers
                if side == "program":
                    got["control"] = control.numbers(r.ref, r.traffic,
                                                     r.loop)

            hooks = {} if side == "program" else faults.hooks(side)
            hooks["judged"] = judged
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", "0"],
                          device=device, hooks=hooks, root=root)
            if rc != 0:
                return rc
            emit(seed, side, got["program"])
            if "control" in got:
                emit(seed, "control", got["control"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
