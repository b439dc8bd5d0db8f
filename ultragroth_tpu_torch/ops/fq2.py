"""Plain PyTorch Fq2 = Fq[u]/(u^2+1) on limb planes.

The twin of the JAX package's `ops/fq2.py`.  An Fq2 batch is ONE tensor
[2, 8, *batch]: component c0 = a[0], c1 = a[1] (the JAX package keeps a
(c0, c1) tuple).  Same formulas: Karatsuba multiply (3 base products);
the curve code squares through the multiply.  Componentwise ops and the base
products of one formula each run as ONE Fq op over the components stacked
on a trailing axis: the plain versions are bound by the count of tensor
ops, not by their width.
"""
from __future__ import annotations

import torch

from .field import FieldOps, fq


class Fq2Ops:
    def __init__(self, base: FieldOps | None = None):
        self.fq = base or fq()

    def zero(self, batch_shape=(), device="cpu", dtype=None):
        z = self.fq.zero(batch_shape, device, dtype)
        return torch.stack([z, z])

    def one_mont(self, batch_shape=(), device="cpu", dtype=None):
        return torch.stack([self.fq.one_mont(batch_shape, device, dtype),
                            self.fq.zero(batch_shape, device, dtype)])

    def add(self, a, b):
        return _per_comp(self.fq.add, a, b)

    def sub(self, a, b):
        return _per_comp(self.fq.sub, a, b)

    def neg(self, a):
        return _per_comp(self.fq.neg, a)

    def mont_mul(self, a, b):
        """Karatsuba: 3 base muls (ops/fq2.py:39-47 of the JAX package)."""
        F = self.fq
        sa, sb = torch.broadcast_tensors(a, b)
        ka = torch.stack([sa[0], sa[1], F.add(sa[0], sa[1])], -1)
        kb = torch.stack([sb[0], sb[1], F.add(sb[0], sb[1])], -1)
        t0, t1, t2 = F.mont_mul(ka, kb).unbind(-1)
        d = F.sub(torch.stack([t0, t2], -1), torch.stack([t1, t0], -1))
        return torch.stack([d[..., 0], F.sub(d[..., 1], t1)])

    def batch_inv_mont(self, a):
        """Fq2 inversion through ONE Fq batch inversion of the norms
        a0^2 + a1^2; inv(0) = 0."""
        F = self.fq
        norm = F.add(F.mont_mul(a[0], a[0]), F.mont_mul(a[1], a[1]))
        ninv = F.batch_inv_mont(norm)
        return torch.stack([F.mont_mul(a[0], ninv),
                            F.neg(F.mont_mul(a[1], ninv))])

    def is_zero(self, a):
        return self.fq.is_zero(a[0]) & self.fq.is_zero(a[1])

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond, a, b)


def _per_comp(op, *xs):
    """An Fq op on both components at once: [2, 8, *b] -> [8, *b, 2]."""
    return op(*[x.movedim(0, -1) for x in xs]).movedim(-1, 0)
