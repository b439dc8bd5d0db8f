"""Oracle optimal-ate pairing on BN254 over Python ints.

Used by the host-side Groth16 / UltraGroth verifiers (parity with
src/groth16.cpp:314-690 and src/ultra_groth.cpp:581-974),
and as the oracle the end-to-end prover tests check proofs against.

Textbook construction: Miller loop f_{6u+2,Q}(P) with affine line functions
on the D-type sextic twist, two Frobenius correction lines, then the full
final exponentiation (easy part + naive hard-part power; this is an oracle,
clarity beats speed).
"""
from __future__ import annotations

from ..constants import FQ_MODULUS as Q, FR_MODULUS, ATE_LOOP_COUNT, FQ2_NON_RESIDUE as XI
from . import field as F
from .field import (
    fq2_add, fq2_sub, fq2_mul, fq2_square, fq2_inv, fq2_neg, fq2_conj,
    fq2_mul_scalar, fq2_pow, fq12_mul, fq12_square, fq12_conj, fq12_inv,
    fq12_pow, fq12_frobenius, FQ12_ONE, FQ2_ZERO, FQ6_ZERO,
)

# Frobenius twist constants: xi^((q-1)/3), xi^((q-1)/2) in Fq2, and the Fq
# scalar xi^((q^2-1)/3).  These equal the strings pinned in the reference
# verifier constructor (src/groth16.cpp:298-312).
XI_TO_P_MINUS1_OVER_3 = fq2_pow(XI, (Q - 1) // 3)
XI_TO_P_MINUS1_OVER_2 = fq2_pow(XI, (Q - 1) // 2)
# xi^((q^2-1)/3) lands in Fq; xi^((q^2-1)/2) = -1 (xi is a non-square).
XI_TO_P2_MINUS1_OVER_3 = fq2_pow(XI, (Q * Q - 1) // 3)[0]


def _sparse_line(y_p, c_w, c_vw):
    """Fq12 element  y_p + c_w * w + c_vw * (v*w)  (c in Fq2, y_p in Fq)."""
    c0 = ((y_p % Q, 0), FQ2_ZERO, FQ2_ZERO)
    c1 = (c_w, c_vw, FQ2_ZERO)
    return (c0, c1)


def _line_double(t, p):
    """Tangent line at twist point t, evaluated at G1 point p.

    Returns (line in Fq12, 2t).  t affine Fq2 pair; p affine ints.
    """
    xt, yt = t
    xp, yp = p
    lam = fq2_mul(_three(fq2_square(xt)), fq2_inv(fq2_add(yt, yt)))
    x3 = fq2_sub(fq2_square(lam), fq2_add(xt, xt))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    # l(P) = y_p - lam*x_p*w + (lam*x_t - y_t)*v*w
    c_w = fq2_mul_scalar(fq2_neg(lam), xp)
    c_vw = fq2_sub(fq2_mul(lam, xt), yt)
    return _sparse_line(yp, c_w, c_vw), (x3, y3)


def _line_add(t, q, p):
    """Chord line through twist points t, q evaluated at p. Returns (line, t+q)."""
    xt, yt = t
    xq, yq = q
    xp, yp = p
    lam = fq2_mul(fq2_sub(yq, yt), fq2_inv(fq2_sub(xq, xt)))
    x3 = fq2_sub(fq2_sub(fq2_square(lam), xt), xq)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    c_w = fq2_mul_scalar(fq2_neg(lam), xp)
    c_vw = fq2_sub(fq2_mul(lam, xt), yt)
    return _sparse_line(yp, c_w, c_vw), (x3, y3)


def _three(a):
    return fq2_add(fq2_add(a, a), a)


def miller_loop(q_point, p_point):
    """f_{6u+2, Q}(P) * (two frobenius lines); both points affine, not None."""
    f = FQ12_ONE
    t = q_point
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip the leading 1
    for b in bits:
        line, t = _line_double(t, p_point)
        f = fq12_mul(fq12_square(f), line)
        if b == "1":
            line, t = _line_add(t, q_point, p_point)
            f = fq12_mul(f, line)

    # Frobenius corrections: Q1 = pi_q(Q), Q2 = pi_{q^2}(Q); add Q1, sub Q2.
    xq, yq = q_point
    q1 = (fq2_mul(fq2_conj(xq), XI_TO_P_MINUS1_OVER_3),
          fq2_mul(fq2_conj(yq), XI_TO_P_MINUS1_OVER_2))
    # pi_{q^2}(Q) = (x * xi^((q^2-1)/3), -y), so -Q2 keeps +y.
    minus_q2 = (fq2_mul_scalar(xq, XI_TO_P2_MINUS1_OVER_3), yq)

    line, t = _line_add(t, q1, p_point)
    f = fq12_mul(f, line)
    line, t = _line_add(t, minus_q2, p_point)
    f = fq12_mul(f, line)
    return f


def final_exponentiation(f):
    """f^((q^12-1)/r).  Easy part fast, hard part by plain square-multiply."""
    # easy: f^(q^6-1) then ^(q^2+1)
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    f = fq12_mul(fq12_frobenius(f, 2), f)
    # hard: ^((q^4 - q^2 + 1)/r)
    hard = (Q ** 4 - Q ** 2 + 1) // FR_MODULUS
    return fq12_pow(f, hard)


def pairing(p_point, q_point):
    """Full pairing e(P, Q) for affine G1 P and G2 Q (None -> 1)."""
    if p_point is None or q_point is None:
        return FQ12_ONE
    return final_exponentiation(miller_loop(q_point, p_point))


def pairing_check(g1_points, g2_points):
    """prod e(P_i, Q_i) == 1, skipping infinities — parity with
    Verifier::pairingCheck (src/groth16.cpp:672-690)."""
    acc = FQ12_ONE
    for p_point, q_point in zip(g1_points, g2_points):
        if p_point is None or q_point is None:
            continue
        acc = fq12_mul(acc, miller_loop(q_point, p_point))
    return final_exponentiation(acc) == FQ12_ONE
