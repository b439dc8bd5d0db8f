"""Plain PyTorch short-Weierstrass group law in XYZZ coordinates (a = 0).

The twin of the JAX package's `ops/curve.py` `CurveOps` and the plain
version of the curve kernels in `csrc/curve.cuh`: the same formulas
(madd-2008-s, add-2008-s, dbl-2008-s-1 of the EFD) and the same order of
special-case selects, so a kernel's canonical output equals this module's
exactly, lane for lane.

Encodings: a field element is [8, *batch] (Fq) or [2, 8, *batch] (Fq2).
An xyzz batch is ONE tensor [4, *elem, *batch] = (X, Y, ZZ, ZZZ), infinity
<=> ZZ == 0; an affine batch is [2, *elem, *batch] = (x, y) with infinity
carried by a separate bool mask [*batch] (the zkey writes it as (0, 0)).
A point table of the MSMs is point-major, [N, 2, *elem] (`table_from_
planes`): point i's affine words are contiguous, in the zkey's own order.
"""
from __future__ import annotations

import torch

from .field import fq
from .fq2 import Fq2Ops


class CurveOps:
    def __init__(self, F, elem_dims: int):
        self.F = F
        self.elem_dims = elem_dims      # 1 for Fq elements, 2 for Fq2

    # -- constructors ------------------------------------------------------

    def inf_xyzz(self, batch_shape=(), device="cpu", dtype=None):
        one = self.F.one_mont(batch_shape, device, dtype)
        z = self.F.zero(batch_shape, device, dtype)
        return torch.stack([one, one, z, z])

    def affine_to_xyzz(self, x, y, inf):
        """(x, y) Montgomery-form affine + inf mask -> xyzz batch."""
        one = self.F.one_mont(x.shape[self.elem_dims:], x.device, x.dtype)
        zz = torch.where(inf, torch.zeros_like(x), one)
        return torch.stack([x, y, zz, zz])

    def is_inf(self, p):
        return self.F.is_zero(p[2])

    def _mul_many(self, pairs):
        """[(a1, b1), ...] -> [a1*b1, ...] through ONE field multiply on
        operands stacked along a new trailing axis."""
        a = torch.stack([torch.broadcast_tensors(x, y)[0] for x, y in pairs], -1)
        b = torch.stack([torch.broadcast_tensors(x, y)[1] for x, y in pairs], -1)
        return self.F.mont_mul(a, b).unbind(-1)

    # -- group law ---------------------------------------------------------

    def dbl(self, p):
        """dbl-2008-s-1 (a = 0)."""
        F = self.F
        x1, y1, zz1, zzz1 = p
        u = F.add(y1, y1)
        v, xx = self._mul_many([(u, u), (x1, x1)])
        m = F.add(F.add(xx, xx), xx)
        w, s, mm = self._mul_many([(u, v), (x1, v), (m, m)])
        x3 = F.sub(mm, F.add(s, s))
        t1, t2, zz3, zzz3 = self._mul_many(
            [(m, F.sub(s, x3)), (w, y1), (v, zz1), (w, zzz1)])
        return torch.stack([x3, F.sub(t1, t2), zz3, zzz3])

    def _add_core(self, x1, y1, zz1, zzz1, u1, u2, s1, s2, zz_a, zzz_a):
        """Shared tail of madd / add: returns (sum, same_x, same_y)."""
        F = self.F
        pp_ = F.sub(u2, u1)
        r_ = F.sub(s2, s1)
        pp, rr = self._mul_many([(pp_, pp_), (r_, r_)])
        ppp, q_, zz3 = self._mul_many([(pp_, pp), (u1, pp), (zz_a, pp)])
        x3 = F.sub(F.sub(rr, ppp), F.add(q_, q_))
        t1, t2, zzz3 = self._mul_many(
            [(r_, F.sub(q_, x3)), (s1, ppp), (zzz_a, ppp)])
        added = torch.stack([x3, F.sub(t1, t2), zz3, zzz3])
        return added, F.is_zero(pp_), F.is_zero(r_)

    def madd_unified(self, p, qx, qy, q_inf):
        """Complete mixed add: xyzz P + affine Q -> xyzz."""
        x1, y1, zz1, zzz1 = p
        p_inf = self.is_inf(p)
        u2, s2 = self._mul_many([(qx, zz1), (qy, zzz1)])
        added, same_x, same_y = self._add_core(
            x1, y1, zz1, zzz1, x1, u2, y1, s2, zz1, zzz1)
        q_xyzz = self.affine_to_xyzz(qx, qy, q_inf)
        doubled = self.dbl(q_xyzz)
        out = self.select(same_x & same_y, doubled, added)
        out = self.select(same_x & ~same_y & ~p_inf & ~q_inf,
                          self.inf_xyzz(same_x.shape, qx.device, qx.dtype), out)
        out = self.select(q_inf, p, out)
        return self.select(p_inf, q_xyzz, out)

    def madd_fast(self, p, qx, qy):
        """INCOMPLETE mixed add (10 muls): assumes P != inf, Q != inf,
        P != +-Q; returns (P+Q, bad) with `bad` marking lanes where x1 ==
        u2 (doubling or cancellation) or P is at infinity."""
        x1, y1, zz1, zzz1 = p
        u2, s2 = self._mul_many([(qx, zz1), (qy, zzz1)])
        added, same_x, _ = self._add_core(
            x1, y1, zz1, zzz1, x1, u2, y1, s2, zz1, zzz1)
        return added, same_x | self.F.is_zero(zz1)

    def add_unified(self, p, q):
        """Complete xyzz + xyzz add (doubles when p == q)."""
        x1, y1, zz1, zzz1 = p
        x2, y2, zz2, zzz2 = q
        p_inf = self.is_inf(p)
        q_inf = self.is_inf(q)
        u1, u2, s1, s2 = self._mul_many(
            [(x1, zz2), (x2, zz1), (y1, zzz2), (y2, zzz1)])
        zz_a, zzz_a = self._mul_many([(zz1, zz2), (zzz1, zzz2)])
        added, same_x, same_y = self._add_core(
            x1, y1, zz1, zzz1, u1, u2, s1, s2, zz_a, zzz_a)
        out = self.select(same_x & same_y, self.dbl(p), added)
        out = self.select(same_x & ~same_y & ~p_inf & ~q_inf,
                          self.inf_xyzz(same_x.shape, x1.device, x1.dtype), out)
        out = self.select(q_inf, p, out)
        return self.select(p_inf, q, out)

    def neg(self, p):
        return torch.stack([p[0], self.F.neg(p[1]), p[2], p[3]])

    @staticmethod
    def select(cond, a, b):
        """cond [*batch]; a, b xyzz batches."""
        return torch.where(cond, a, b)

    # -- normalization -----------------------------------------------------

    def to_affine(self, p):
        """xyzz -> (x, y, inf) Montgomery-form affine through ONE batch
        inversion of the stacked (ZZ, ZZZ) lanes; inf(0) = 0, so infinity
        lanes come out as (0, 0)."""
        inf = self.is_inf(p)
        both = torch.stack([p[2], p[3]], dim=-1)
        inv = self.F.batch_inv_mont(both)
        xa, ya = self._mul_many([(p[0], inv[..., 0]), (p[1], inv[..., 1])])
        return xa, ya, inf


def table_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """Affine planes [2, *elem, N] -> the point-major table [N, 2,
    *elem] of the MSMs, which the bucket drain gathers a point at a
    time (csrc/curve.cuh)."""
    return planes.movedim(-1, 0).contiguous()


def table_planes(table: torch.Tensor) -> torch.Tensor:
    """Point-major table [N, 2, *elem] -> affine planes [2, *elem,
    N] (a view)."""
    return table.movedim(0, -1)


def g1_ops() -> CurveOps:
    return CurveOps(fq(), 1)


def g2_ops() -> CurveOps:
    return CurveOps(Fq2Ops(), 2)


def curve_ops(group: str) -> CurveOps:
    return g1_ops() if group == "g1" else g2_ops()
