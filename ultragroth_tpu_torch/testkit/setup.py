"""Trusted-setup simulator: generates Groth16 / UltraGroth zkeys from R1CS.

The reference repo ships no UltraGroth fixture (no .uwtns, no 1337-protocol
zkey - SURVEY.md section 4), so we synthesize our own, matching the binary
section maps of src/zkey_utils.hpp:11-42 and
src/zkey_utils.cpp:123-163 exactly.  Also used to build synthetic circuits
for benchmarking.

Math layout (derived from the prover/verifier contract, see
protocol/quotient.py for the H-basis R^2 scale):
  pointsA[i]  = [A_i(tau)]1          pointsB*[i] = [B_i(tau)]{1,2}
  IC[i]       = [(beta*A_i + alpha*B_i + C_i)(tau) / gamma]1
  pointsC[i]  = [... / delta]1  (UltraGroth: delta_round for c1 vars,
                                 delta_final for c2 vars)
  pointsH[j]  = [Lc_j(tau) * (tau^n - 1) * R^2 / (-2 * delta)]1
where Lc_j is the Lagrange basis over the ODD COSET {w_2n * w_n^j} (the
evaluation points of the reference's quotient pipeline, src/groth16.cpp:
110-148; Z == -2 on that coset since w_2n^n = -1).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..constants import FR_MODULUS as R, FQ_MODULUS as Q, MONT_R
from ..io.binfile import pack_binfile
from ..io.fieldenc import ints_to_array
from ..oracle import curve as oc
from ..protocol.transcript import root_of_unity


@dataclass
class R1CS:
    """Sparse constraint system: rows of (A, B, C) dicts var -> coef."""
    n_vars: int
    n_public: int          # public signals (excluding the leading 1)
    rows: list = field(default_factory=list)

    def add(self, a: dict, b: dict, c: dict):
        self.rows.append((a, b, c))


def _domain_size(n_rows: int) -> int:
    n = 1
    while n < max(n_rows, 2):
        n <<= 1
    return n


def _lagrange_at_tau(tau: int, n: int, w: int):
    """L_c(tau) for c in 0..n-1 over the standard domain {w^c}."""
    zt = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    out = []
    wc = 1
    for _ in range(n):
        out.append(zt * wc % R * pow((tau - wc) % R, -1, R) % R * n_inv % R)
        wc = wc * w % R
    return out


def _coset_lagrange_at_tau(tau: int, n: int, w: int, s: int):
    """Lc_j(tau) over the coset {s * w^j}; Z_coset(x) = x^n - s^n."""
    sn = pow(s, n, R)
    zt = (pow(tau, n, R) - sn) % R
    n_inv = pow(n, -1, R)
    out = []
    xj = s
    for _ in range(n):
        # Lc_j(tau) = Z_coset(tau) / (tau - x_j) * x_j / (n * s^n)
        out.append(zt * pow((tau - xj) % R, -1, R) % R * xj % R
                   * n_inv % R * pow(sn, -1, R) % R)
        xj = xj * w % R
    return out


def _enc_fq_mont(v: int) -> np.ndarray:
    return ints_to_array([(v * MONT_R) % Q])[0]


def _enc_g1(p) -> bytes:
    if p is None:
        return b"\0" * 64
    return _enc_fq_mont(p[0]).tobytes() + _enc_fq_mont(p[1]).tobytes()


def _enc_g2(p) -> bytes:
    if p is None:
        return b"\0" * 128
    (xa, xb), (ya, yb) = p
    return b"".join(_enc_fq_mont(v).tobytes() for v in (xa, xb, ya, yb))


def _enc_fr_mont(v: int) -> bytes:
    return ints_to_array([(v * MONT_R) % R])[0].tobytes()


class _FixedBase:
    """Windowed fixed-base scalar multiplication (8-bit windows)."""

    def __init__(self, base, add, n_windows=32):
        self.add = add
        self.tables = []
        cur = base
        for _ in range(n_windows):
            row = [None] * 256
            acc = None
            for d in range(1, 256):
                acc = add(acc, cur)
                row[d] = acc
            self.tables.append(row)
            cur = add(acc, cur)  # acc = 255*cur -> acc + cur = 256*cur

    def mul(self, k: int):
        k %= R
        acc = None
        w = 0
        while k:
            d = k & 0xFF
            if d:
                acc = self.add(acc, self.tables[w][d])
            k >>= 8
            w += 1
        return acc


def _poly_evals_at_tau(rows, n_vars, which: int, lag, n):
    """A_i(tau) (which=0), B_i (1), C_i (2) for every variable i."""
    out = [0] * n_vars
    for c, row in enumerate(rows):
        for s, v in row[which].items():
            out[s] = (out[s] + v % R * lag[c]) % R
    return out


@dataclass
class SetupResult:
    zkey_bytes: bytes
    vk_json: dict
    taus: dict  # toxic waste, kept for test introspection
    seconds: dict = field(default_factory=dict)   # by part (device set-up)


def _common(r1cs: R1CS, rng: random.Random):
    n = _domain_size(len(r1cs.rows))
    log_n = n.bit_length() - 1
    w = root_of_unity(log_n)
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    lag = _lagrange_at_tau(tau, n, w)
    a_t = _poly_evals_at_tau(r1cs.rows, r1cs.n_vars, 0, lag, n)
    b_t = _poly_evals_at_tau(r1cs.rows, r1cs.n_vars, 1, lag, n)
    c_t = _poly_evals_at_tau(r1cs.rows, r1cs.n_vars, 2, lag, n)
    k_t = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % R
           for i in range(r1cs.n_vars)]
    g1 = _FixedBase(oc.G1, oc.g1_add)
    g2 = _FixedBase(oc.G2, oc.g2_add)
    return n, log_n, w, tau, alpha, beta, gamma, a_t, b_t, k_t, g1, g2


def _h_points(g1, tau, n, log_n, w, delta: int):
    s = root_of_unity(log_n + 1)
    lc = _coset_lagrange_at_tau(tau, n, w, s)
    zt = (pow(tau, n, R) - 1) % R
    scale = zt * MONT_R % R * MONT_R % R * pow(-2 * delta % R, -1, R) % R
    return [g1.mul(lc[j] * scale % R) for j in range(n)]


def _groth_header_blob(q, r, n_vars, n_public, domain_size, extra=b""):
    out = bytearray()
    out += (32).to_bytes(4, "little")
    out += q.to_bytes(32, "little")
    out += (32).to_bytes(4, "little")
    out += r.to_bytes(32, "little")
    out += n_vars.to_bytes(4, "little")
    out += n_public.to_bytes(4, "little")
    out += domain_size.to_bytes(4, "little")
    out += extra
    return out


def _coefs_blob(rows) -> bytes:
    """Section 4: u32 count + packed {m,c,s,coef:32B Montgomery} records
    (struct at src/groth16.hpp:42-50, count prefix per src/groth16.cpp:38)."""
    recs = []
    for c, (a, b, _) in enumerate(rows):
        for s, v in a.items():
            recs.append((0, c, s, v % R))
        for s, v in b.items():
            recs.append((1, c, s, v % R))
    out = bytearray(len(recs).to_bytes(4, "little"))
    for m, c, s, v in recs:
        out += m.to_bytes(4, "little") + c.to_bytes(4, "little")
        out += s.to_bytes(4, "little") + _enc_fr_mont(v)
    return bytes(out)


def groth16_setup(r1cs: R1CS, seed: int = 0) -> SetupResult:
    """Protocol-1 zkey + verification key JSON."""
    rng = random.Random(seed)
    n, log_n, w, tau, alpha, beta, gamma, a_t, b_t, k_t, g1, g2 = _common(r1cs, rng)
    delta = rng.randrange(1, R)
    np_pub = r1cs.n_public

    ic = [g1.mul(k_t[i] * pow(gamma, -1, R) % R) for i in range(np_pub + 1)]
    points_a = [g1.mul(a_t[i]) for i in range(r1cs.n_vars)]
    points_b1 = [g1.mul(b_t[i]) for i in range(r1cs.n_vars)]
    points_b2 = [g2.mul(b_t[i]) for i in range(r1cs.n_vars)]
    dinv = pow(delta, -1, R)
    points_c = [g1.mul(k_t[i] * dinv % R)
                for i in range(np_pub + 1, r1cs.n_vars)]
    points_h = _h_points(g1, tau, n, log_n, w, delta)

    alpha1, beta1 = g1.mul(alpha), g1.mul(beta)
    beta2, gamma2 = g2.mul(beta), g2.mul(gamma)
    delta1, delta2 = g1.mul(delta), g2.mul(delta)

    hdr = _groth_header_blob(Q, R, r1cs.n_vars, np_pub, n)
    hdr += _enc_g1(alpha1) + _enc_g1(beta1) + _enc_g2(beta2)
    hdr += _enc_g2(gamma2) + _enc_g1(delta1) + _enc_g2(delta2)

    sections = [
        (C.ZKEY_SEC_HEADER, C.GROTH16_PROTOCOL_ID.to_bytes(4, "little")),
        (C.ZKEY_SEC_GROTH_HEADER, bytes(hdr)),
        (C.ZKEY_SEC_IC, b"".join(_enc_g1(p) for p in ic)),
        (C.ZKEY_SEC_COEFS, _coefs_blob(r1cs.rows)),
        (C.ZKEY_SEC_POINTS_A, b"".join(_enc_g1(p) for p in points_a)),
        (C.ZKEY_SEC_POINTS_B1, b"".join(_enc_g1(p) for p in points_b1)),
        (C.ZKEY_SEC_POINTS_B2, b"".join(_enc_g2(p) for p in points_b2)),
        (C.ZKEY_SEC_POINTS_C, b"".join(_enc_g1(p) for p in points_c)),
        (C.ZKEY_SEC_POINTS_H, b"".join(_enc_g1(p) for p in points_h)),
    ]
    from ..protocol.transcript import g1_to_json, g2_to_json
    vk = {
        "protocol": "groth16", "curve": "bn128", "nPublic": np_pub,
        "vk_alpha_1": g1_to_json(alpha1), "vk_beta_2": g2_to_json(beta2),
        "vk_gamma_2": g2_to_json(gamma2), "vk_delta_2": g2_to_json(delta2),
        "IC": [g1_to_json(p) for p in ic],
    }
    return SetupResult(
        zkey_bytes=pack_binfile(C.ZKEY_MAGIC, 1, sections), vk_json=vk,
        taus=dict(tau=tau, alpha=alpha, beta=beta, gamma=gamma, delta=delta))


@dataclass
class UltraSetupResult:
    zkey_bytes: bytes
    vk_json: dict
    taus: dict
    seconds: dict = field(default_factory=dict)   # by part (device set-up)


def ultragroth_setup(r1cs: R1CS, round_indexes, final_indexes,
                     rand_indx: int, seed: int = 0) -> UltraSetupResult:
    """Protocol-1337 zkey (section map: src/zkey_utils.cpp:123-163).

    round_indexes (c1): witness vars committed in round 0 (delta_round);
    final_indexes (c2): remaining private vars (delta_final);
    rand_indx: public-signal index carrying the Fiat-Shamir challenge.
    """
    rng = random.Random(seed)
    n, log_n, w, tau, alpha, beta, gamma, a_t, b_t, k_t, g1, g2 = _common(r1cs, rng)
    delta_r = rng.randrange(1, R)
    delta_f = rng.randrange(1, R)
    np_pub = r1cs.n_public

    # IC over {0} + publics except rand_indx; ic_rand for rand_indx
    ginv = pow(gamma, -1, R)
    ic = [g1.mul(k_t[i] * ginv % R)
          for i in range(np_pub + 1) if i != rand_indx]
    ic_rand = g1.mul(k_t[rand_indx] * ginv % R)

    points_a = [g1.mul(a_t[i]) for i in range(r1cs.n_vars)]
    points_b1 = [g1.mul(b_t[i]) for i in range(r1cs.n_vars)]
    points_b2 = [g2.mul(b_t[i]) for i in range(r1cs.n_vars)]
    dr_inv, df_inv = pow(delta_r, -1, R), pow(delta_f, -1, R)
    round_points_c = [g1.mul(k_t[i] * dr_inv % R) for i in round_indexes]
    final_points_c = [g1.mul(k_t[i] * df_inv % R) for i in final_indexes]
    points_h = _h_points(g1, tau, n, log_n, w, delta_f)

    alpha1, beta1 = g1.mul(alpha), g1.mul(beta)
    beta2, gamma2 = g2.mul(beta), g2.mul(gamma)
    rd1, rd2 = g1.mul(delta_r), g2.mul(delta_r)
    fd1, fd2 = g1.mul(delta_f), g2.mul(delta_f)

    extra = (len(round_indexes).to_bytes(4, "little")
             + len(final_indexes).to_bytes(4, "little")
             + rand_indx.to_bytes(4, "little"))
    hdr = _groth_header_blob(Q, R, r1cs.n_vars, np_pub, n, extra)
    hdr += _enc_g1(alpha1) + _enc_g1(beta1) + _enc_g2(beta2) + _enc_g2(gamma2)
    hdr += _enc_g1(rd1) + _enc_g2(rd2) + _enc_g1(fd1) + _enc_g2(fd2)

    idx_blob = lambda idxs: np.asarray(idxs, dtype="<u4").tobytes()
    sections = [
        (C.ZKEY_SEC_HEADER, C.ULTRAGROTH_PROTOCOL_ID.to_bytes(4, "little")),
        (C.ZKEY_SEC_GROTH_HEADER, bytes(hdr)),
        (C.ZKEY_SEC_IC, b"".join(_enc_g1(p) for p in ic)),
        (C.ZKEY_SEC_COEFS, _coefs_blob(r1cs.rows)),
        (C.ZKEY_SEC_POINTS_A, b"".join(_enc_g1(p) for p in points_a)),
        (C.ZKEY_SEC_POINTS_B1, b"".join(_enc_g1(p) for p in points_b1)),
        (C.ZKEY_SEC_POINTS_B2, b"".join(_enc_g2(p) for p in points_b2)),
        (C.UG_SEC_ROUND_POINTS_C, b"".join(_enc_g1(p) for p in round_points_c)),
        (C.UG_SEC_FINAL_POINTS_C, b"".join(_enc_g1(p) for p in final_points_c)),
        (C.UG_SEC_ROUND_INDEXES, idx_blob(round_indexes)),
        (C.UG_SEC_FINAL_INDEXES, idx_blob(final_indexes)),
        (C.UG_SEC_POINTS_H, b"".join(_enc_g1(p) for p in points_h)),
    ]
    from ..protocol.transcript import g1_to_json, g2_to_json
    vk = {
        "protocol": "ultragroth", "curve": "bn128",
        "vk_alpha_1": g1_to_json(alpha1), "vk_beta_2": g2_to_json(beta2),
        "vk_gamma_2": g2_to_json(gamma2),
        "vk_delta_c2_2": g2_to_json(fd2), "vk_delta_c1_2": g2_to_json(rd2),
        "IC": [g1_to_json(p) for p in ic], "IC_rand": g1_to_json(ic_rand),
        "randIdx": rand_indx,
    }
    return UltraSetupResult(
        zkey_bytes=pack_binfile(C.ZKEY_MAGIC, 1, sections), vk_json=vk,
        taus=dict(tau=tau, alpha=alpha, beta=beta, gamma=gamma,
                  delta_r=delta_r, delta_f=delta_f))
