"""Synthetic circuits: UltraGroth lookup fixture + Groth16 bench circuits.

The lookup circuit mirrors the Bionetta logup layout described in
src/README.md:13-45: chunk signals committed in round 0,
challenge-derived inverse/product signals in the final round, and the
rand signal exposed as a public input re-derived by the verifier.
"""
from __future__ import annotations

import random

import numpy as np

from .. import constants as C
from ..constants import FR_MODULUS as R
from ..io.binfile import pack_binfile
from ..io.fieldenc import ints_to_array
from .setup import R1CS


class LookupCircuit:
    """Variables:
      0                  : one
      1                  : rand (public; Fiat-Shamir challenge), rand_indx=1
      2                  : pub_x (regular public input)
      3 .. 3+K-1         : chunk signals (round 0, c1)
      then K inv1, T inv2, T prod signals (final round, c2).

    Constraints:
      (chunk_j + rand) * inv1_j = 1          for each chunk
      (i + rand) * inv2_i = 1                for each table entry
      freq_i * inv2_i = prod_i
      (sum_j inv1_j - sum_i prod_i) * 1 = 0  (logup balance)
      pub_x * 1 = pub_x
    """

    def __init__(self, chunk_values, table_size: int, pub_x: int = 42):
        K, T = len(chunk_values), table_size
        assert all(0 <= int(c) < T for c in chunk_values)
        self.K, self.T = K, T
        self.chunk_values = [int(c) for c in chunk_values]
        self.pub_x = pub_x % R
        # one counting pass (list.count per table entry is K * T steps:
        # ~6e10 at K ~ 2^20, T = 2^16)
        self.frequencies = np.bincount(
            np.asarray(self.chunk_values, dtype=np.int64),
            minlength=T).tolist()

        v_one, v_rand, v_pub = 0, 1, 2
        self.rand_indx = v_rand
        v_chunk = [3 + j for j in range(K)]
        v_inv1 = [3 + K + j for j in range(K)]
        v_inv2 = [3 + 2 * K + i for i in range(T)]
        v_prod = [3 + 2 * K + T + i for i in range(T)]
        n_vars = 3 + 2 * K + 2 * T

        r1cs = R1CS(n_vars=n_vars, n_public=2)
        for j in range(K):
            r1cs.add({v_chunk[j]: 1, v_rand: 1}, {v_inv1[j]: 1}, {v_one: 1})
        for i in range(T):
            r1cs.add({v_one: i, v_rand: 1}, {v_inv2[i]: 1}, {v_one: 1})
        for i in range(T):
            r1cs.add({v_one: self.frequencies[i]}, {v_inv2[i]: 1},
                     {v_prod[i]: 1})
        bal = {v: 1 for v in v_inv1}
        bal.update({v: R - 1 for v in v_prod})
        r1cs.add(bal, {v_one: 1}, {})
        r1cs.add({v_pub: 1}, {v_one: 1}, {v_pub: 1})
        self.r1cs = r1cs

        self.round_indexes = list(v_chunk)
        self.final_indexes = v_inv1 + v_inv2 + v_prod
        # push_vector layout: [rand | inv1 (K) | inv2 (T) | prod (T)]
        self.wtns_indxs = [v_rand] + v_inv1 + v_inv2 + v_prod
        self.push_indxs = list(range(1 + K + 2 * T))

    def witness_words(self) -> np.ndarray:
        """Initial witness (lookup signals zero; prover fills them), as
        [n_vars, 8] u32 words; written into the array directly, since the
        chunk values fit one word."""
        w = np.zeros((self.r1cs.n_vars, 8), dtype=np.uint32)
        w[0, 0] = 1
        w[2] = ints_to_array([self.pub_x])[0]
        w[3:3 + self.K, 0] = np.asarray(self.chunk_values, dtype=np.uint32)
        return w

    def uwtns_bytes(self) -> bytes:
        """.uwtns container (sections per src/prover.cpp:287-292)."""
        w = self.witness_words()
        sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
                + self.r1cs.n_vars.to_bytes(4, "little"))
        u32 = lambda xs: np.asarray(xs, dtype="<u4").tobytes()
        return pack_binfile(C.WTNS_MAGIC, 2, [
            (1, sec1),
            (2, w.tobytes()),
            (C.UWTNS_SEC_CHUNKS, u32(self.chunk_values)),
            (C.UWTNS_SEC_FREQUENCIES, u32(self.frequencies)),
            (C.UWTNS_SEC_WTNS_INDEXES, u32(self.wtns_indxs)),
            (C.UWTNS_SEC_PUSH_INDEXES, u32(self.push_indxs)),
        ])


def square_chain_circuit(n_constraints: int, seed: int = 1):
    """Groth16 bench circuit: x_{i+1} = x_i^2 chain, one public output.

    Returns (R1CS, witness_words).  nVars = n_constraints + 2.
    """
    rng = random.Random(seed)
    x0 = rng.randrange(2, R)
    vals = [x0]
    for _ in range(n_constraints):
        vals.append(vals[-1] * vals[-1] % R)
    # vars: 0 = one, 1 = public output (last value), 2.. = chain values
    n_vars = n_constraints + 2
    r1cs = R1CS(n_vars=n_vars, n_public=1)
    # rows: v_{i+1} = v_i * v_i with chain vars at 2..; last row maps to
    # the public var.
    for i in range(n_constraints):
        src = 2 + i
        dst = 1 if i == n_constraints - 1 else 3 + i
        r1cs.add({src: 1}, {src: 1}, {dst: 1})
    w = [0] * n_vars
    w[0] = 1
    w[1] = vals[-1]
    for i in range(n_constraints):
        w[2 + i] = vals[i]
    return r1cs, ints_to_array(w)
