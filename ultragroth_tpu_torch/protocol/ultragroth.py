"""UltraGroth: 2-round lookup-argument Groth16 variant (prover + verifier).

The port's copy of the JAX package's `protocol/ultragroth.py` (host-side
Python; no JAX in it).

Protocol parity with src/ultra_groth.cpp:
  round 0      - commitment D = MSM(round_pointsC, w[round_indexes])
                 + r0 * [delta_final]1                    (:161-184)
  challenge    - keccak256(D.x || D.y as 32B big-endian) reduced mod r
                 (:32-58); reused verbatim by the verifier (:603-612)
  lookup       - inv2[i] = 1/(i + rand); prod[i] = freq[i] * inv2[i];
                 inv1[j] = inv2[chunks[j]]; push_vector =
                 [rand, inv1, inv2, prod]; w[wtns_indxs] scattered (:61-106)
  final round  - Groth16 pipeline with C-MSM over final_wtns, blinding by
                 delta_final, and pi_c -= r0 * [delta_round]1  (:187-399)
  verify       - 5-pairing check with vkX += derived_rand * IC_rand
                 (:581-648)

Byte-order note: derive_challenge ingests the keccak digest BIG-endian.
The reference's mpz_import uses the out-of-spec order=0 (:54), which GMP
executes as order>=0, i.e. most-significant byte first — pinned against
the actual libgmp in tests/test_fs_interop.py.  (Round 1 read it as
little-endian; that diverged from the reference on every challenge.)
"""
from __future__ import annotations

import json
import secrets
from dataclasses import dataclass

import numpy as np

from ..constants import FR_MODULUS as R
from ..io.fieldenc import array_to_ints, ints_to_array
from ..keccak import keccak256
from ..oracle import curve as oc
from ..oracle import pairing as op
from . import quotient
from .groth16 import decode_g1, decode_g2, decode_g1_batch, decode_g2_batch, \
    random_blinding
from .transcript import g1_to_json, g2_to_json, g1_from_json, g2_from_json


def derive_challenge(commitment) -> int:
    """Fiat-Shamir: keccak256(x||y big-endian 32B each) mod r.

    Parity: src/ultra_groth.cpp:32-58 (mpz_export order=1/size=8/endian=1
    == 32-byte big-endian; digest ingested with mpz_import order=0, which
    GMP treats as order>=0 == big-endian — see tests/test_fs_interop.py).
    """
    if commitment is None:
        buf = b"\0" * 64
    else:
        x, y = commitment
        buf = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    digest = keccak256(buf)
    return int.from_bytes(digest, "big") % R


def compute_lookup(witness: list, chunks, frequencies, wtns_indxs,
                   push_indxs, rand: int) -> None:
    """Scatter the challenge-derived lookup signals into the witness.

    witness: mutable list of standard-form ints (mutated in place).
    Parity: compute_lookup, src/ultra_groth.cpp:61-106.
    """
    lookup_size = len(frequencies)
    inv2 = [pow((i + rand) % R, -1, R) if (i + rand) % R else 0
            for i in range(lookup_size)]
    prod = [int(frequencies[i]) * inv2[i] % R for i in range(lookup_size)]
    inv1 = [inv2[int(c)] for c in chunks]
    push_vector = [rand] + inv1 + inv2 + prod
    for wi, pi in zip(wtns_indxs, push_indxs):
        witness[int(wi)] = push_vector[int(pi)]


@dataclass
class UltraGrothProof:
    pi_a: tuple
    pi_b: tuple
    pi_f: tuple   # final commitment
    pi_r: tuple   # round commitment

    def to_json_dict(self) -> dict:
        """Key layout parity: Proof::toJson, src/ultra_groth.cpp:476-513."""
        return {
            "pi_a": g1_to_json(self.pi_a),
            "pi_b": g2_to_json(self.pi_b),
            "pi_f": g1_to_json(self.pi_f),
            "pi_r": g1_to_json(self.pi_r),
            "protocol": "ultragroth",
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @classmethod
    def from_json_dict(cls, d: dict) -> "UltraGrothProof":
        if d.get("protocol") != "ultragroth":
            raise ValueError("invalid proof data")
        return cls(pi_a=g1_from_json(d["pi_a"]), pi_b=g2_from_json(d["pi_b"]),
                   pi_f=g1_from_json(d["pi_f"]), pi_r=g1_from_json(d["pi_r"]))


@dataclass
class UltraGrothVerificationKey:
    """JSON keys parity: VerificationKey::fromJson, src/ultra_groth.cpp:
    542-563 (vk_delta_c2_2 = final, vk_delta_c1_2 = round)."""
    alpha: tuple
    beta: tuple
    gamma: tuple
    final_delta: tuple
    round_delta: tuple
    ic: list
    ic_rand: tuple

    @classmethod
    def from_json_dict(cls, d: dict) -> "UltraGrothVerificationKey":
        # gating parity: ultra_groth_parse_key, src/verifier.cpp:128-141
        if d.get("protocol") != "ultragroth" or d.get("curve") != "bn128":
            raise ValueError(
                "invalid verification key data: protocol does not match")
        if not d.get("IC"):
            raise ValueError("invalid verification key data: IC is empty")
        return cls(alpha=g1_from_json(d["vk_alpha_1"]),
                   beta=g2_from_json(d["vk_beta_2"]),
                   gamma=g2_from_json(d["vk_gamma_2"]),
                   final_delta=g2_from_json(d["vk_delta_c2_2"]),
                   round_delta=g2_from_json(d["vk_delta_c1_2"]),
                   ic=[g1_from_json(v) for v in d["IC"]],
                   ic_rand=g1_from_json(d["IC_rand"]))


def verify(proof: UltraGrothProof, public_inputs: list,
           vk: UltraGrothVerificationKey) -> bool:
    """5-pairing check; re-derives the challenge from pi_r.

    Parity: Verifier::verify, src/ultra_groth.cpp:581-648.
    """
    if len(public_inputs) + 1 != len(vk.ic):
        raise ValueError("len(inputs)+1 != len(vk.IC)")
    vk_x = vk.ic[0]
    for inp, point in zip(public_inputs, vk.ic[1:]):
        vk_x = oc.g1_add(vk_x, oc.g1_mul(point, inp % R))
    rand = derive_challenge(proof.pi_r)
    vk_x = oc.g1_add(vk_x, oc.g1_mul(vk.ic_rand, rand))
    return op.pairing_check(
        [proof.pi_a, oc.g1_neg(vk.alpha), oc.g1_neg(vk_x),
         oc.g1_neg(proof.pi_f), oc.g1_neg(proof.pi_r)],
        [proof.pi_b, vk.beta, vk.gamma, vk.final_delta, vk.round_delta],
    )


class OracleUltraGrothProver:
    """Host-math 2-round prover; the oracle for the device twin."""

    def __init__(self, zkey):
        self.zk = zkey
        zk = zkey
        self.alpha1 = decode_g1(zk.alpha1)
        self.beta1 = decode_g1(zk.beta1)
        self.beta2 = decode_g2(zk.beta2)
        self.round_delta1 = decode_g1(zk.round_delta1)
        self.final_delta1 = decode_g1(zk.final_delta1)
        self.final_delta2 = decode_g2(zk.final_delta2)
        self.points_a = decode_g1_batch(zk.points_a)
        self.points_b1 = decode_g1_batch(zk.points_b1)
        self.points_b2 = decode_g2_batch(zk.points_b2)
        self.round_points_c = decode_g1_batch(zk.round_points_c)
        self.final_points_c = decode_g1_batch(zk.final_points_c)
        self.points_h = decode_g1_batch(zk.points_h)
        from ..io.fieldenc import mont_decode_fr
        self.coef_vals = [mont_decode_fr(v) for v in array_to_ints(zk.coef_val)]

    def prove(self, witness_words: np.ndarray, lookup, r0=None, r=None,
              s=None) -> UltraGrothProof:
        """lookup: object with chunks/frequencies/wtns_indxs/push_indxs."""
        zk = self.zk
        w = array_to_ints(witness_words)
        if len(w) != zk.n_vars:
            raise ValueError("Invalid witness length.")
        r0 = random_blinding() if r0 is None else r0
        r = random_blinding() if r is None else r
        s = random_blinding() if s is None else s

        # round 0: commitment over the challenge-independent witness slice
        round_wtns = [w[i] for i in zk.round_indexes]
        d = oc.g1_msm_fast(self.round_points_c, round_wtns)
        d = oc.g1_add(d, oc.g1_mul(self.final_delta1, r0))

        rand = derive_challenge(d)
        compute_lookup(w, lookup.chunks, lookup.frequencies,
                       lookup.wtns_indxs, lookup.push_indxs, rand)

        final_wtns = [w[i] for i in zk.final_indexes]

        # final round == Groth16 pipeline with delta_final blinding
        pi_a = oc.g1_msm_fast(self.points_a, w)
        pi_b1 = oc.g1_msm_fast(self.points_b1, w)
        pi_b = oc.g2_msm_fast(self.points_b2, w)
        pi_c = oc.g1_msm_fast(self.final_points_c, final_wtns)

        a, b = quotient.scatter_coefs(zk.coef_m, zk.coef_c, zk.coef_s,
                                      self.coef_vals, w, zk.domain_size)
        h = quotient.quotient_evals(a, b, zk.domain_size)
        pi_h = oc.g1_msm_fast(self.points_h, h)

        return finalize_ultragroth(self, pi_a, pi_b1, pi_b, pi_c, pi_h,
                                   d, r0, r, s), w


def finalize_ultragroth(pk, pi_a, pi_b1, pi_b, pi_c, pi_h, round_commitment,
                        r0: int, r: int, s: int) -> UltraGrothProof:
    """Blinding algebra parity: execute_final_round tail,
    src/ultra_groth.cpp:337-399 (delta_final blinds A/B/C, extra
    -r0*[delta_round]1 term cancels the round commitment blinding)."""
    pi_a = oc.g1_add(pi_a, pk.alpha1)
    pi_a = oc.g1_add(pi_a, oc.g1_mul(pk.final_delta1, r))

    pi_b = oc.g2_add(pi_b, pk.beta2)
    pi_b = oc.g2_add(pi_b, oc.g2_mul(pk.final_delta2, s))

    pi_b1 = oc.g1_add(pi_b1, pk.beta1)
    pi_b1 = oc.g1_add(pi_b1, oc.g1_mul(pk.final_delta1, s))

    pi_c = oc.g1_add(pi_c, pi_h)
    pi_c = oc.g1_add(pi_c, oc.g1_mul(pi_a, s))
    pi_c = oc.g1_add(pi_c, oc.g1_mul(pi_b1, r))
    pi_c = oc.g1_add(pi_c, oc.g1_neg(oc.g1_mul(pk.final_delta1, (r * s) % R)))
    pi_c = oc.g1_add(pi_c, oc.g1_neg(oc.g1_mul(pk.round_delta1, r0)))
    return UltraGrothProof(pi_a=pi_a, pi_b=pi_b, pi_f=pi_c,
                           pi_r=round_commitment)


def public_signals(witness_ints: list, n_public: int, rand_indx: int) -> list:
    """Publics excluding the challenge signal (src/prover.cpp:89-105)."""
    return [witness_ints[i] for i in range(1, n_public + 1) if i != rand_indx]
