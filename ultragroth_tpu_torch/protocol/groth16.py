"""Groth16 prover + verifier (BN254), protocol parity with the reference.

Prove pipeline parity: Groth16::Prover::prove (src/
groth16.cpp:48-203).  Verifier parity: Groth16::Verifier::verify
(src/groth16.cpp:314-364).

Two execution backends share this module:
  * "oracle": pure Python ints (slow, obviously correct);
  * "torch":  CUDA limb-plane kernels (protocol/prover.py over ops/msm.py,
              ops/ntt.py) — the hot path.
"""
from __future__ import annotations

import json
import secrets
from dataclasses import dataclass

import numpy as np

from ..constants import FR_MODULUS as R, MONT_R
from ..io.fieldenc import words_to_int, array_to_ints, mont_decode_fq, mont_decode_fr
from ..oracle import curve as oc
from ..oracle import pairing as op
from . import quotient
from .transcript import g1_to_json, g2_to_json, g1_from_json, g2_from_json


def decode_g1(arr) -> tuple | None:
    """[2, 8] u32 Montgomery-form words -> affine int pair (None if zero)."""
    x = mont_decode_fq(words_to_int(arr[0]))
    y = mont_decode_fq(words_to_int(arr[1]))
    if x == 0 and y == 0:
        return None
    return (x, y)


def decode_g2(arr) -> tuple | None:
    xa = mont_decode_fq(words_to_int(arr[0]))
    xb = mont_decode_fq(words_to_int(arr[1]))
    ya = mont_decode_fq(words_to_int(arr[2]))
    yb = mont_decode_fq(words_to_int(arr[3]))
    if xa == 0 and xb == 0 and ya == 0 and yb == 0:
        return None
    return ((xa, xb), (ya, yb))


def decode_g1_batch(arr) -> list:
    ints = array_to_ints(arr.reshape(-1, 8))
    out = []
    for i in range(0, len(ints), 2):
        x = mont_decode_fq(ints[i])
        y = mont_decode_fq(ints[i + 1])
        out.append(None if x == 0 and y == 0 else (x, y))
    return out


def decode_g2_batch(arr) -> list:
    ints = array_to_ints(arr.reshape(-1, 8))
    out = []
    for i in range(0, len(ints), 4):
        xa, xb, ya, yb = (mont_decode_fq(v) for v in ints[i:i + 4])
        out.append(None if xa == xb == ya == yb == 0 else ((xa, xb), (ya, yb)))
    return out


def random_blinding() -> int:
    """31 random bytes, top byte zero — parity with src/groth16.cpp:165-166."""
    return int.from_bytes(secrets.token_bytes(31), "little")


@dataclass
class Proof:
    pi_a: tuple
    pi_b: tuple
    pi_c: tuple

    def to_json_dict(self) -> dict:
        return {
            "pi_a": g1_to_json(self.pi_a),
            "pi_b": g2_to_json(self.pi_b),
            "pi_c": g1_to_json(self.pi_c),
            "protocol": "groth16",
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @classmethod
    def from_json_dict(cls, d: dict) -> "Proof":
        if d.get("protocol") != "groth16":
            raise ValueError("invalid proof data")
        return cls(pi_a=g1_from_json(d["pi_a"]), pi_b=g2_from_json(d["pi_b"]),
                   pi_c=g1_from_json(d["pi_c"]))


class OracleGroth16Prover:
    """Host-math prover: the oracle the CUDA prover is validated against."""

    def __init__(self, zkey):
        self.zk = zkey
        zk = zkey
        self.alpha1 = decode_g1(zk.alpha1)
        self.beta1 = decode_g1(zk.beta1)
        self.beta2 = decode_g2(zk.beta2)
        self.delta1 = decode_g1(zk.delta1)
        self.delta2 = decode_g2(zk.delta2)
        self.points_a = decode_g1_batch(zk.points_a)
        self.points_b1 = decode_g1_batch(zk.points_b1)
        self.points_b2 = decode_g2_batch(zk.points_b2)
        self.points_c = decode_g1_batch(zk.points_c)
        self.points_h = decode_g1_batch(zk.points_h)
        self.coef_vals = [mont_decode_fr(v) for v in array_to_ints(zk.coef_val)]

    def prove(self, witness_words: np.ndarray, r: int | None = None,
              s: int | None = None) -> Proof:
        zk = self.zk
        w = array_to_ints(witness_words)
        if len(w) != zk.n_vars:
            raise ValueError("Invalid witness length.")
        r = random_blinding() if r is None else r
        s = random_blinding() if s is None else s

        pi_a = oc.g1_msm_fast(self.points_a, w)
        pi_b1 = oc.g1_msm_fast(self.points_b1, w)
        pi_b = oc.g2_msm_fast(self.points_b2, w)
        pi_c = oc.g1_msm_fast(self.points_c, w[zk.n_public + 1:])

        a, b = quotient.scatter_coefs(zk.coef_m, zk.coef_c, zk.coef_s,
                                      self.coef_vals, w, zk.domain_size)
        h = quotient.quotient_evals(a, b, zk.domain_size)
        pi_h = oc.g1_msm_fast(self.points_h, h)

        return finalize_proof(self, pi_a, pi_b1, pi_b, pi_c, pi_h, r, s)


def finalize_proof(pk, pi_a, pi_b1, pi_b, pi_c, pi_h, r: int, s: int) -> Proof:
    """Blinding algebra — parity with src/groth16.cpp:158-202.

    pk provides alpha1/beta1/beta2/delta1/delta2 as oracle affine points.
    """
    pi_a = oc.g1_add(pi_a, pk.alpha1)
    pi_a = oc.g1_add(pi_a, oc.g1_mul(pk.delta1, r))

    pi_b = oc.g2_add(pi_b, pk.beta2)
    pi_b = oc.g2_add(pi_b, oc.g2_mul(pk.delta2, s))

    pi_b1 = oc.g1_add(pi_b1, pk.beta1)
    pi_b1 = oc.g1_add(pi_b1, oc.g1_mul(pk.delta1, s))

    pi_c = oc.g1_add(pi_c, pi_h)
    pi_c = oc.g1_add(pi_c, oc.g1_mul(pi_a, s))
    pi_c = oc.g1_add(pi_c, oc.g1_mul(pi_b1, r))
    pi_c = oc.g1_add(pi_c, oc.g1_neg(oc.g1_mul(pk.delta1, (r * s) % R)))
    return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


@dataclass
class VerificationKey:
    alpha: tuple
    beta: tuple
    gamma: tuple
    delta: tuple
    ic: list

    @classmethod
    def from_json_dict(cls, d: dict) -> "VerificationKey":
        if d.get("protocol") != "groth16" or d.get("curve") != "bn128":
            raise ValueError("invalid verification key data")
        ic = [g1_from_json(v) for v in d["IC"]]
        if not ic:
            raise ValueError("invalid verification key data")
        return cls(alpha=g1_from_json(d["vk_alpha_1"]),
                   beta=g2_from_json(d["vk_beta_2"]),
                   gamma=g2_from_json(d["vk_gamma_2"]),
                   delta=g2_from_json(d["vk_delta_2"]),
                   ic=ic)


def verify(proof: Proof, public_inputs: list, vk: VerificationKey) -> bool:
    """Parity: Groth16::Verifier::verify (src/groth16.cpp:314-364)."""
    if len(public_inputs) + 1 != len(vk.ic):
        raise ValueError("len(inputs)+1 != len(vk.IC)")
    vk_x = vk.ic[0]
    for inp, point in zip(public_inputs, vk.ic[1:]):
        vk_x = oc.g1_add(vk_x, oc.g1_mul(point, inp % R))
    return op.pairing_check(
        [proof.pi_a, oc.g1_neg(vk.alpha), oc.g1_neg(vk_x), oc.g1_neg(proof.pi_c)],
        [proof.pi_b, vk.beta, vk.gamma, vk.delta],
    )
