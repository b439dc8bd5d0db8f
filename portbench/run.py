"""The benchmark of the PyTorch/CUDA prover, one run of one cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress and, last, each number the
correctness check compared beside its limit on standard error; prints one
JSON object as the last line of standard output (`bench.run`).  Exits 3
without a result when the cell's cards are not there, 4 when JAX or the
JAX package was loaded in this process, 5 when the run failed."""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    pin_cpus()
    import torch
    from . import bench
    root = bench.HERE.parent
    cell = bench.load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                           args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    bench.configure_program(bench.HERE / "_cache")
    try:
        import ultragroth_tpu_torch.api  # noqa: F401  (the program, first)
        result = bench.run(cell, args.seed, args.seconds, bool(args.trace))
    except Exception:
        traceback.print_exc()
        return 5
    found = bench.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (must be {c['holds']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def pin_cpus() -> None:
    """Pin this process, and the threads it starts from now on, to the
    upper half of the CPUs it may run on, before torch starts its threads.
    The host-bound parts of a prove (the finalisation in Python integers,
    the launches) set the spread between runs; pinning takes the
    scheduler's moves between cores out of it (`PERF.md`, section 2)."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[len(cpus) // 2:])


if __name__ == "__main__":
    sys.exit(main())
