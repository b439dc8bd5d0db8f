"""Oracle BN254 G1/G2 group law over Python ints (affine + Jacobian).

Points:
  G1 affine: (x, y) ints, or None for infinity.
  G2 affine: ((x0,x1), (y0,y1)) Fq2 pairs, or None.

Used for test vectors and host-side verifier math; the device path lives in
`ultragroth_tpu_torch.ops.curve`.
"""
from __future__ import annotations

from ..constants import FQ_MODULUS as Q, FR_MODULUS, CURVE_B, G2_B, G1_GENERATOR, G2_GENERATOR
from . import field as F


# ---------------------------------------------------------------------------
# Generic affine group law parameterized by a field implementation.
# ---------------------------------------------------------------------------

class _Ops:
    """Field op bundle so G1 (Fq) and G2 (Fq2) share one group law."""

    def __init__(self, add, sub, mul, inv, neg, zero, one, b):
        self.add, self.sub, self.mul, self.inv, self.neg = add, sub, mul, inv, neg
        self.zero, self.one, self.b = zero, one, b


_G1OPS = _Ops(F.fq_add, F.fq_sub, F.fq_mul, F.fq_inv,
              lambda a: (-a) % Q, 0, 1, CURVE_B)
_G2OPS = _Ops(F.fq2_add, F.fq2_sub, F.fq2_mul, F.fq2_inv,
              F.fq2_neg, F.FQ2_ZERO, F.FQ2_ONE, G2_B)


def _affine_add(o: _Ops, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2 or y1 == o.zero:
            return None  # p == -q (covers the 2-torsion y == 0 case)
        lam = o.mul(_scalar3(o, x1), o.inv(o.add(y1, y1)))
    else:
        lam = o.mul(o.sub(y2, y1), o.inv(o.sub(x2, x1)))
    x3 = o.sub(o.sub(o.mul(lam, lam), x1), x2)
    y3 = o.sub(o.mul(lam, o.sub(x1, x3)), y1)
    return (x3, y3)


def _scalar3(o: _Ops, x):
    xx = o.mul(x, x)
    return o.add(o.add(xx, xx), xx)


def _affine_neg(o: _Ops, p):
    if p is None:
        return None
    return (p[0], o.neg(p[1]))


def _affine_mul(o: _Ops, p, k: int):
    k %= FR_MODULUS
    result = None
    acc = p
    while k:
        if k & 1:
            result = _affine_add(o, result, acc)
        acc = _affine_add(o, acc, acc)
        k >>= 1
    return result


def _on_curve(o: _Ops, p):
    if p is None:
        return True
    x, y = p
    lhs = o.mul(y, y)
    rhs = o.add(o.mul(o.mul(x, x), x), o.b)
    return lhs == rhs


# G1 API ---------------------------------------------------------------------

def g1_add(p, q):
    return _affine_add(_G1OPS, p, q)


def g1_neg(p):
    return _affine_neg(_G1OPS, p)


def g1_mul(p, k):
    return _affine_mul(_G1OPS, p, k)


def g1_is_on_curve(p):
    return _on_curve(_G1OPS, p)


def g1_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if s % FR_MODULUS == 0 or p is None:
            continue
        acc = g1_add(acc, g1_mul(p, s))
    return acc


G1 = G1_GENERATOR

# G2 API ---------------------------------------------------------------------

def g2_add(p, q):
    return _affine_add(_G2OPS, p, q)


def g2_neg(p):
    return _affine_neg(_G2OPS, p)


def g2_mul(p, k):
    return _affine_mul(_G2OPS, p, k)


def g2_is_on_curve(p):
    return _on_curve(_G2OPS, p)


def g2_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if s % FR_MODULUS == 0 or p is None:
            continue
        acc = g2_add(acc, g2_mul(p, s))
    return acc


G2 = G2_GENERATOR


# ---------------------------------------------------------------------------
# Pippenger MSM (host oracle; the device version lives in ops/msm.py)
# ---------------------------------------------------------------------------

def _pippenger(o: _Ops, points, scalars, c: int = 8):
    scalars = [s % FR_MODULUS for s in scalars]
    n_windows = (254 + c - 1) // c
    window_sums = []
    for w in range(n_windows):
        buckets = [None] * (1 << c)
        shift = w * c
        for p, s in zip(points, scalars):
            d = (s >> shift) & ((1 << c) - 1)
            if d and p is not None:
                buckets[d] = _affine_add(o, buckets[d], p)
        # sum_b b * B_b via running suffix sums
        running = None
        total = None
        for b in range(len(buckets) - 1, 0, -1):
            running = _affine_add(o, running, buckets[b])
            total = _affine_add(o, total, running)
        window_sums.append(total)
    # combine: sum_w 2^(cw) * S_w, Horner from the top
    acc = None
    for s_w in reversed(window_sums):
        for _ in range(c):
            acc = _affine_add(o, acc, acc)
        acc = _affine_add(o, acc, s_w)
    return acc


def g1_msm_fast(points, scalars, c: int = 8):
    return _pippenger(_G1OPS, points, scalars, c)


def g2_msm_fast(points, scalars, c: int = 8):
    return _pippenger(_G2OPS, points, scalars, c)
