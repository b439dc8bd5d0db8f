"""The benchmark's reference prover and key against the port's CPU path
and against plain integer arithmetic, at tiny sizes."""
import json
import random

import numpy as np
import pytest

from portbench import circuits, keygen
from portbench.circuits.binfile import read_wtns, sections
from portbench.reference import curve as ec
from portbench.reference.curve import Q, R
from portbench.reference.field import Field
from portbench.reference.keccak import keccak256
from portbench.reference.prover import ReferenceProver
from portbench.reference.quotient import Domain, quotient
from portbench.tests._tiny import CONFIGS

TINY = {"groth16": "g16_tiny", "ultragroth": "ug_tiny"}


def _deployment(protocol):
    cfg = CONFIGS[TINY[protocol]]
    circuit = circuits.kind(cfg["circuit"])
    dep = circuit.build(cfg)
    return cfg, circuit, dep, keygen.key_logs(dep, cfg["key_seed"])


@pytest.mark.parametrize("protocol", ["groth16", "ultragroth"])
def test_reference_proof_equals_the_ports(protocol, monkeypatch):
    """Proof for proof, public for public, with pinned blinding."""
    monkeypatch.setenv("ULTRAGROTH_PLATFORM", "cpu")
    from ultragroth_tpu_torch import api
    cfg, circuit, dep, logs = _deployment(protocol)
    zkey = keygen.zkey_bytes(dep, logs, "cpu")
    cls = api.Groth16Prover if protocol == "groth16" else api.UltraGrothProver
    prover = cls(zkey, device="cpu")
    w = circuit.witness(dep, random.Random(11))
    blind = {"r": 3 << 200, "s": (5 << 190) + 17}
    if protocol == "ultragroth":
        blind["r0"] = (7 << 180) + 1
    proof, publics = prover.prove(w.data, **blind)
    want, want_pub, _ = ReferenceProver(dep, logs).expected(
        w.values, w.lookup, blind)
    assert json.loads(proof) == want
    assert json.loads(publics) == want_pub
    values, lookup = read_wtns(w.data)
    assert np.array_equal(values, w.values)
    assert (lookup is None) == (protocol == "groth16")


def _point(words: bytes, g2: bool):
    ints = [int.from_bytes(words[i:i + 32], "little") * pow(1 << 256, -1, Q) % Q
            for i in range(0, len(words), 32)]
    return ((ints[0], ints[1]), (ints[2], ints[3])) if g2 else tuple(ints)


@pytest.mark.parametrize("protocol", ["groth16", "ultragroth"])
def test_key_points_are_their_known_logs(protocol):
    cfg, circuit, dep, logs = _deployment(protocol)
    sec = sections(keygen.zkey_bytes(dep, logs, "cpu"))
    numbers = ({"a": 5, "b1": 6, "b2": 7, "c": 8, "h": 9}
               if protocol == "groth16"
               else {"a": 5, "b1": 6, "b2": 7, "rc": 8, "fc": 9, "h": 12})
    for name, stype in numbers.items():
        group, idx = dep.sections[name]
        g2 = group == "g2"
        size = 128 if g2 else 64
        n = dep.domain if idx is None else len(idx)
        assert len(sec[stype]) == n * size
        gen = ec.G2 if g2 else ec.G1
        inf = dep.at_infinity(name)
        for i in range(n):
            raw = sec[stype][i * size:(i + 1) * size]
            if inf is not None and inf[i]:
                assert raw == bytes(size), (name, i)
                continue
            got = _point(raw, g2)
            assert got == ec.mul(gen, keygen.known_log(
                logs.sections[name], i)), (name, i)
            assert ec.on_curve(got)
    if protocol == "ultragroth":
        # the chunks are in no B row: their B1 / B2 points are infinity
        ex = dep.extra
        assert dep.at_infinity("b2")[ex["round_indexes"]].all()
        assert not dep.at_infinity("a")[ex["round_indexes"]].any()


def test_key_rows_beyond_one_1024_row():
    """Points past the first row of 1024 (m > 0) and a ragged last row."""
    F = Field(Q)
    spec = (12345, 678, 91011)
    got = keygen.section_points(F, "g1", spec, 2050)
    for i in (0, 1, 1023, 1024, 1025, 2048, 2049):
        want = ec.mul(ec.G1, keygen.known_log(spec, i))
        assert _point(got[i].tobytes(), False) == want, i


def test_field_against_integers():
    rng = random.Random(2)
    for p in (R, Q):
        F = Field(p)
        xs = [rng.randrange(p) for _ in range(64)] + [0, 1, p - 1]
        ys = [rng.randrange(p) for _ in range(64)] + [p - 1, 0, p - 1]
        a, b = F.tensor(xs), F.tensor(ys)
        rinv = pow(1 << 256, -1, p)
        assert F.to_ints(F.mul(a, b)) == [x * y * rinv % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
        nz = [x or 3 for x in xs]
        inv = F.from_mont(F.batch_inv_mont(F.to_mont(F.tensor(nz))))
        assert F.to_ints(inv) == [pow(x, -1, p) for x in nz]


@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_quotient_against_the_ports_host_oracle(log_n):
    from ultragroth_tpu_torch.protocol import quotient as oq
    rng = random.Random(log_n)
    n = 1 << log_n
    a = [rng.randrange(R) for _ in range(n)]
    b = [rng.randrange(R) for _ in range(n)]
    F = Field(R)
    got = quotient(F, Domain(F, log_n), F.tensor(a), F.tensor(b))
    assert F.to_ints(got) == oq.quotient_evals(a, b, n)


def test_curve_and_keccak():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    k = 0x1234567890ABCDEF
    assert ec.mul(ec.G1, k) == ec.affine_add(
        ec.Fq, ec.mul(ec.G1, k - 1), ec.G1)
    assert ec.mul(ec.G2, R - 1) == (ec.G2[0], tuple((-v) % Q for v in ec.G2[1]))
    assert ec.mul(ec.G1, R) is None
