"""The control of the benchmark's correctness check: the reference put in
the program's place with every MSM scalar cut to 224 bits (one 32-bit
limb fewer than the configuration's exact 254-bit arithmetic), proving
through the harness's own window and check.  Its proofs must come out as
not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds S]

prints, for each seed, the numbers the check compared (`checks`)."""
from __future__ import annotations

import argparse
import json
import sys

from . import bench
from .circuits.binfile import read_wtns
from .reference.prover import ReferenceProver

CONTROL_BITS = 224


class ControlProver:
    """`api.*Prover`'s prove() over the reference at CONTROL_BITS."""

    def __init__(self, dep, logs, device, bits: int = CONTROL_BITS):
        self.ref = ReferenceProver(dep, logs, device, scalar_bits=bits)
        self.cache: dict = {}

    def prove(self, data: bytes, **blind):
        values, lookup = read_wtns(data)
        proof, publics, _ = self.ref.expected(values, lookup, blind,
                                              self.cache, id(data))
        return json.dumps(proof), json.dumps(publics)


def factory(dep, logs, zkey, device):
    return ControlProver(dep, logs, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    root = bench.HERE.parent
    cell = bench.load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                           args.workload, False)
    for seed in args.seeds.split(","):
        res = bench.run(cell, int(seed), args.seconds, False, device="cuda",
                        prover_factory=factory)
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "control_bits": CONTROL_BITS,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
