"""CLI twins of the reference binaries, on the port: the twin of the JAX
package's `cli.py`, with the same commands, arguments and exit codes.

  prove        <circuit.zkey> <witness.wtns> <proof.json> <public.json>
  prove-ultra  <circuit.zkey> <witness.uwtns> <proof.json> <public.json>
  verify       <verification_key.json> <inputs.json> <proof.json>
  verify-ultra (the same; exit code 0 for a valid proof, 1 otherwise)
  setup / setup-ultra  synthetic zkeys (square chain / lookup circuit)

    python -m ultragroth_tpu_torch.cli prove c.zkey w.wtns proof.json pub.json

`--backend torch` (the default) proves on the device ULTRAGROTH_PLATFORM
picks (cuda unless set to cpu); `--backend oracle` in pure Python.
`--devices N` (or `all`) shards the prove over N devices of that platform;
the default, or 1, proves on one.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_prove(args, ultra: bool):
    from . import api
    cls = api.UltraGrothProver if ultra else api.Groth16Prover
    devices = None if args.devices in (None, "1") else args.devices
    try:
        prover = cls.from_file(args.zkey, backend=args.backend,
                               devices=devices)
        proof_json, public_json = prover.prove(open(args.wtns, "rb").read())
    except api.ProverError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    with open(args.proof, "w") as f:
        f.write(proof_json)
    with open(args.public, "w") as f:
        f.write(public_json)
    return 0


def _cmd_verify(args, ultra: bool):
    from . import api
    fn = api.ultra_groth_verify if ultra else api.groth16_verify
    code = fn(open(args.proof).read(), open(args.inputs).read(),
              open(args.vk).read())
    if code == api.VERIFIER_VALID_PROOF:
        print("Result: Valid proof", file=sys.stderr)
        return 0
    if code == api.VERIFIER_INVALID_PROOF:
        print("Result: Invalid proof", file=sys.stderr)
        return 1
    print("Error: invalid proof/inputs/key data", file=sys.stderr)
    return 1


def _cmd_setup(args):
    """Write a synthetic Groth16 zkey + vk (+ witness) of a square chain."""
    import json
    from . import constants as C
    from .constants import FR_MODULUS as R
    from .io.binfile import pack_binfile
    from .testkit.circuits import square_chain_circuit
    from .testkit.setup import groth16_setup
    r1cs, wtns = square_chain_circuit(args.constraints, seed=args.seed)
    res = groth16_setup(r1cs, seed=args.seed)
    open(args.zkey, "wb").write(res.zkey_bytes)
    if args.vk:
        json.dump(res.vk_json, open(args.vk, "w"))
    if args.wtns:
        sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
                + r1cs.n_vars.to_bytes(4, "little"))
        open(args.wtns, "wb").write(pack_binfile(
            C.WTNS_MAGIC, 2, [(1, sec1), (2, wtns.tobytes())]))
    print(f"wrote {args.zkey}: nVars={r1cs.n_vars} rows={len(r1cs.rows)}")
    return 0


def _cmd_setup_ultra(args):
    """Write a synthetic UltraGroth zkey + vk + uwtns (lookup circuit)."""
    import json
    import random
    from .testkit.circuits import LookupCircuit
    from .testkit.setup import ultragroth_setup
    rng = random.Random(args.seed)
    chunks = [rng.randrange(args.table_size) for _ in range(args.chunks)]
    circ = LookupCircuit(chunks, args.table_size)
    res = ultragroth_setup(circ.r1cs, circ.round_indexes, circ.final_indexes,
                           circ.rand_indx, seed=args.seed)
    open(args.zkey, "wb").write(res.zkey_bytes)
    if args.vk:
        json.dump(res.vk_json, open(args.vk, "w"))
    if args.uwtns:
        open(args.uwtns, "wb").write(circ.uwtns_bytes())
    print(f"wrote {args.zkey}: nVars={circ.r1cs.n_vars} "
          f"chunks={args.chunks} table={args.table_size}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ultragroth_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name, ultra in (("prove", False), ("prove-ultra", True)):
        p = sub.add_parser(name)
        p.add_argument("zkey")
        p.add_argument("wtns")
        p.add_argument("proof")
        p.add_argument("public")
        p.add_argument("--backend", default="torch",
                       choices=["torch", "oracle"])
        p.add_argument("--devices", default=None,
                       help="shard the prove over N devices ('all' = every "
                            "visible device); default single-device")
        p.set_defaults(fn=lambda a, u=ultra: _cmd_prove(a, u))

    for name, ultra in (("verify", False), ("verify-ultra", True)):
        p = sub.add_parser(name)
        p.add_argument("vk")
        p.add_argument("inputs")
        p.add_argument("proof")
        p.set_defaults(fn=lambda a, u=ultra: _cmd_verify(a, u))

    p = sub.add_parser("setup")
    p.add_argument("zkey")
    p.add_argument("--vk", default=None)
    p.add_argument("--wtns", default=None)
    p.add_argument("--constraints", type=int, default=1 << 10)
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(fn=_cmd_setup)

    p = sub.add_parser("setup-ultra")
    p.add_argument("zkey")
    p.add_argument("--vk", default=None)
    p.add_argument("--uwtns", default=None)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--table-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(fn=_cmd_setup_ultra)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
