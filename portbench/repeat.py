"""Run cells of the benchmark several times, each run its own process as
the checks run them, and summarise:

    python3 -m portbench.repeat --out DIR [--seconds S] [--trace 0|1]
        CELL:SEED[,SEED...] [CELL:SEED...]

Each run's standard output and error go to DIR/<cell>-<seed>-t<trace>.{out,err};
one summary line a run is printed (exit code, wall seconds, correct, the
metrics, the run's host, kernel and window lines), then, for each cell
with three runs or more, each metric's median and its spread: the
distance between the first and third quartiles (`statistics.quantiles(values, n=4)`) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values) -> tuple[float, float]:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("runs", nargs="+", help="CELL:SEED[,SEED...]")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    seconds = args.seconds or json.loads(
        (root / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    per_cell: dict = {}
    for spec in args.runs:
        cell, seeds = spec.split(":")
        for seed in seeds.split(","):
            tag = f"{cell}-{seed}-t{args.trace}"
            cmd = [sys.executable, "-m", "portbench.run", "--workload", cell,
                   "--seed", seed, "--seconds", str(seconds),
                   "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            (out / f"{tag}.out").write_text(p.stdout)
            (out / f"{tag}.err").write_text(p.stderr)
            res = None
            if p.returncode == 0 and p.stdout.strip():
                res = json.loads(p.stdout.strip().splitlines()[-1])
                per_cell.setdefault(cell, []).append(res)
            vals = ({k: v["value"] for k, v in res["metrics"].items()}
                    if res else None)
            notes = [ln for ln in p.stderr.splitlines()
                     if ln.startswith(("kernels:", "host", "window:"))]
            print(json.dumps({"run": tag, "rc": p.returncode,
                              "wall_s": round(wall, 2),
                              "correct": res and res["correct"],
                              "metrics": vals,
                              "device": res and res["device"],
                              "notes": notes}),
                  flush=True)
            if p.returncode:
                print(p.stderr[-3000:], flush=True)
    for cell, results in per_cell.items():
        if len(results) < 3:
            continue
        names = results[0]["metrics"].keys()
        summary = {n: spread([r["metrics"][n]["value"] for r in results])
                   for n in names}
        print(json.dumps({"cell": cell, "runs": len(results),
                          "median_and_spread": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
