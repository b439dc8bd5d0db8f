"""Slow, obviously-correct BN254 tower-field arithmetic over Python ints.

This module is the correctness oracle for every device kernel: all CUDA
field ops are property-tested against it.  It is also used directly on the
host for cheap one-off math (pairings, verification, Fiat-Shamir).

Tower: Fq2 = Fq[u]/(u^2+1);  Fq6 = Fq2[v]/(v^3 - xi), xi = 9+u;
       Fq12 = Fq6[w]/(w^2 - v).

Fq2 elements: tuple (c0, c1).  Fq6: ((a0), (a1), (a2)) of Fq2.  Fq12: (c0, c1)
of Fq6.
"""
from __future__ import annotations

from ..constants import FQ_MODULUS as Q
from ..constants import FR_MODULUS as R
from ..constants import FQ2_NON_RESIDUE as XI

# ---------------------------------------------------------------------------
# Prime fields
# ---------------------------------------------------------------------------


def fr_add(a, b):
    return (a + b) % R


def fr_sub(a, b):
    return (a - b) % R


def fr_mul(a, b):
    return (a * b) % R


def fr_inv(a):
    return pow(a, -1, R)


def fq_add(a, b):
    return (a + b) % Q


def fq_sub(a, b):
    return (a - b) % Q


def fq_mul(a, b):
    return (a * b) % Q


def fq_inv(a):
    return pow(a, -1, Q)


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    c0 = (t0 - t1) % Q
    c1 = (a[0] * b[1] + a[1] * b[0]) % Q
    return (c0, c1)


def fq2_mul_scalar(a, s):
    return ((a[0] * s) % Q, (a[1] * s) % Q)


def fq2_square(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    c0 = ((a[0] + a[1]) * (a[0] - a[1])) % Q
    c1 = (2 * a[0] * a[1]) % Q
    return (c0, c1)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, -1, Q)
    return ((a[0] * ninv) % Q, (-a[1] * ninv) % Q)


def fq2_pow(a, e):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_square(base)
        e >>= 1
    return result


def fq2_mul_xi(a):
    # multiply by xi = 9 + u
    c0 = (9 * a[0] - a[1]) % Q
    c1 = (a[0] + 9 * a[1]) % Q
    return (c0, c1)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_square(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    t0 = fq2_square(a0)
    t1 = fq2_square(a1)
    t2 = fq2_square(a2)
    t3 = fq2_mul(a0, a1)
    t4 = fq2_mul(a0, a2)
    t5 = fq2_mul(a1, a2)
    c0 = fq2_sub(t0, fq2_mul_xi(t5))
    c1 = fq2_sub(fq2_mul_xi(t2), t3)
    c2 = fq2_sub(t1, t4)
    t6 = fq2_add(fq2_mul(a0, c0), fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))))
    t6i = fq2_inv(t6)
    return (fq2_mul(c0, t6i), fq2_mul(c1, t6i), fq2_mul(c2, t6i))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_square(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_square(a0), fq6_mul_by_v(fq6_square(a1)))
    ti = fq6_inv(t)
    return (fq6_mul(a0, ti), fq6_neg(fq6_mul(a1, ti)))


def fq12_pow(a, e):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_square(base)
        e >>= 1
    return result


def fq12_is_one(a):
    return a == FQ12_ONE


# Frobenius on Fq12: x -> x^(q^k).  Computed generically via coefficient
# conjugation and gamma constants gamma_{k,i} = xi^(i*(q^k-1)/6).
def _gammas():
    out = {}
    for k in (1, 2, 3):
        e = (Q ** k - 1) // 6
        out[k] = [fq2_pow(XI, i * e) for i in range(6)]
    return out


_GAMMA = _gammas()


def _fq2_frob(a, k):
    # (c0 + c1 u)^(q^k) = c0 + (-1)^k c1 u since u^q = -u
    if k % 2 == 0:
        return a
    return fq2_conj(a)


def fq12_frobenius(a, k=1):
    """a^(q^k) for k in {1,2,3}."""
    g = _GAMMA[k]
    (a0, a1, a2), (b0, b1, b2) = a
    # coefficient i of w^1 v^j picks up gamma power (2j+1); w^0 v^j picks 2j
    c0 = (
        _fq2_frob(a0, k),
        fq2_mul(_fq2_frob(a1, k), g[2]),
        fq2_mul(_fq2_frob(a2, k), g[4]),
    )
    c1 = (
        fq2_mul(_fq2_frob(b0, k), g[1]),
        fq2_mul(_fq2_frob(b1, k), g[3]),
        fq2_mul(_fq2_frob(b2, k), g[5]),
    )
    return (c0, c1)
