"""Quotient-polynomial (H) evaluation — host oracle version.

Mirrors the math of Groth16::Prover::prove's FFT block
(src/groth16.cpp:70-148): sparse scatter of the R1CS
coefficients, pointwise product, and the ifft -> coset-shift -> fft trick
to evaluate h = (a*b - c) / Z on the odd coset.

The device path lives in ultragroth_tpu_torch.ops.ntt; this module is its oracle.
"""
from __future__ import annotations

from ..constants import FR_MODULUS as R, MONT_R
from .transcript import root_of_unity

# The snarkjs zkey PointsH basis is premultiplied by R^2 = 2^512 mod r: the
# reference prover's Montgomery flow (witness standard * coef Montgomery ->
# sigma=1 arrays, pointwise montmul -> sigma=1/R, final fromMontgomery ->
# sigma=1/R^2, src/groth16.cpp:100-148) hands the MSM scalars h/R^2, so the
# setup bakes R^2 into the points.  We compute plain h and scale once here.
# Pinned empirically against testdata/ (only this combination verifies).
H_SCALE = pow(MONT_R, -2, R)


def ntt(values, w):
    """Iterative radix-2 DIT NTT, X_j = sum_k x_k w^{jk}; returns new list."""
    n = len(values)
    a = list(values)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wl = pow(w, n // length, R)
        for start in range(0, n, length):
            cur = 1
            half = length // 2
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * cur % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                cur = cur * wl % R
        length <<= 1
    return a


def intt(values, w):
    n = len(values)
    inv_n = pow(n, -1, R)
    out = ntt(values, pow(w, -1, R))
    return [x * inv_n % R for x in out]


def scatter_coefs(coef_m, coef_c, coef_s, coef_vals, witness, domain_size):
    """a[c] += w[s] * coef for m==0, else b[c] += ... (standard-form ints)."""
    a = [0] * domain_size
    b = [0] * domain_size
    for m, c, s, v in zip(coef_m, coef_c, coef_s, coef_vals):
        tgt = a if m == 0 else b
        tgt[c] = (tgt[c] + witness[s] * v) % R
    return a, b


def quotient_evals(a, b, domain_size):
    """Values of h = (A*B - C) on the odd coset, standard form.

    Input a, b: evaluations over the domain (standard-form ints).
    Output list of domain_size ints: MSM scalars for the H-points basis.
    """
    n = domain_size
    log_n = n.bit_length() - 1
    w_n = root_of_unity(log_n)
    w_2n = root_of_unity(log_n + 1)

    c = [x * y % R for x, y in zip(a, b)]

    def to_odd_coset(vals):
        coeffs = intt(vals, w_n)
        shifted = [coeffs[i] * pow(w_2n, i, R) % R for i in range(n)]
        return ntt(shifted, w_n)

    a2 = to_odd_coset(a)
    b2 = to_odd_coset(b)
    c2 = to_odd_coset(c)
    return [(x * y - z) * H_SCALE % R for x, y, z in zip(a2, b2, c2)]
