"""Plain PyTorch prime-field arithmetic on [8, *batch] 32-bit limb planes.

The twin of the JAX package's `ops/field.py` `FieldOps`, and the plain
version that every CUDA kernel of `csrc/field.cuh` is held against: the
same Montgomery radix R = 2^256 (the zkey wire format), the same values.
Arithmetic runs in int64: products are formed from 16-bit halves, since a
32 x 32-bit product overflows a signed 64-bit value.  Results are always
canonical, in [0, p) — the kernels may keep Fq values lazily in [0, 2p)
inside a launch but canonicalise at every exit, so both sides agree as
integers.

Every public op accepts int32 (u32 bit pattern, the CUDA storage) or int64
limb tensors and answers in the dtype of its first tensor argument.
"""
from __future__ import annotations

import functools

import torch

from ..constants import FQ_MODULUS, FR_MODULUS
from .limbs import (LIMB_MASK, NLIMBS, int_to_limbs, limb_dtype, narrow,
                    planes_to_ints, widen)

L = NLIMBS
M16 = 0xFFFF


def _ripple(x: torch.Tensor, axis: int = 0):
    """Normalise int64 limbs of any sign to 32-bit limbs along `axis`.

    Returns (limbs in [0, 2^32), carry): value(x) = value(limbs) +
    carry * 2^(32 * nlimbs), carry negative when value(x) < 0."""
    x = x.movedim(axis, 0)
    out = []
    c = torch.zeros_like(x[0])
    for j in range(x.shape[0]):
        v = x[j] + c
        out.append(v & LIMB_MASK)
        c = v >> 32
    return torch.stack(out).movedim(0, axis), c


def _pick(pair):
    """pair [2, 8, *b] = (s, s - p) int64 -> s - p where >= 0, else s."""
    (s, d), carry = _ripple(pair, 1)
    return torch.where(carry[1] < 0, s, d)


class FieldOps:
    """Batched modular arithmetic for one prime field, canonical values."""

    def __init__(self, modulus: int, name: str):
        self.p = modulus
        self.name = name
        self.p_limbs = int_to_limbs(modulus)
        self.p16 = [(modulus >> (16 * i)) & M16 for i in range(2 * L)]
        self.ninv16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.r = (1 << 256) % modulus
        self.r2 = (self.r * self.r) % modulus

    # -- constants ---------------------------------------------------------

    def const(self, value: int, batch_shape=(), device="cpu", dtype=None):
        """[8, *batch_shape] planes of one standard-domain value."""
        dtype = dtype or limb_dtype(device)
        limbs = torch.tensor(int_to_limbs(value % self.p), dtype=torch.int64,
                             device=device)
        out = limbs.reshape((L,) + (1,) * len(batch_shape)).expand(
            (L,) + tuple(batch_shape))
        return narrow(out.contiguous(), dtype)

    def zero(self, batch_shape=(), device="cpu", dtype=None):
        return self.const(0, batch_shape, device, dtype)

    def one_mont(self, batch_shape=(), device="cpu", dtype=None):
        return self.const(self.r, batch_shape, device, dtype)

    def _p_planes(self, like: torch.Tensor) -> torch.Tensor:
        p = torch.tensor(self.p_limbs, dtype=torch.int64, device=like.device)
        return p.reshape((L,) + (1,) * (like.dim() - 1))

    # -- tests and selects -------------------------------------------------

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(cond, a, b):
        """cond [*batch] bool; a, b [8, *batch]."""
        return torch.where(cond, a, b)

    # -- modular add / sub / neg -------------------------------------------

    def _reduce_once(self, s):
        """s in [0, 2p) as int64 limbs -> s mod p (one ripple of the pair
        (s, s - p) stacked, so both carry chains run as one)."""
        return _pick(torch.stack([s, s - self._p_planes(s)]))

    def add(self, a, b):
        dtype = a.dtype
        s = widen(a) + widen(b)
        return narrow(_pick(torch.stack([s, s - self._p_planes(s)])), dtype)

    def sub(self, a, b):
        dtype = a.dtype
        d = widen(a) - widen(b)
        # pick d + p when d < 0: stack (d + p, d), the second decides
        (lo, hi), carry = _ripple(torch.stack([d + self._p_planes(d), d]), 1)
        return narrow(torch.where(carry[1] < 0, lo, hi), dtype)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def canon(self, a):
        """[0, 2p) -> [0, p); identity on canonical values."""
        return narrow(self._reduce_once(widen(a)), a.dtype)

    # -- Montgomery multiplication -----------------------------------------

    def mont_mul(self, a, b):
        """(a * b * R^-1) mod p, CIOS over 16-bit digits in int64.

        Accepts any a < 2^256 when b < p (the wide reductions rely on it):
        the result before the final subtract is < 2p."""
        dtype = a.dtype
        a, b = torch.broadcast_tensors(widen(a), widen(b))
        a16 = _split16(a)
        b16 = _split16(b)
        p16 = torch.tensor(self.p16, dtype=torch.int64, device=a.device)
        p16 = p16.reshape((2 * L,) + (1,) * (a.dim() - 1))
        # T: 16-bit positions, redundant; every entry stays < 2^40.  Step i
        # zeroes position i (mod 2^16) and moves its carry up, so the
        # product * R^-1 is left in positions 16..32.
        T = torch.zeros((4 * L + 1,) + a.shape[1:], dtype=torch.int64,
                        device=a.device)
        for i in range(2 * L):
            T[i:i + 2 * L] += a16[i] * b16
            m = ((T[i] & M16) * self.ninv16) & M16
            T[i:i + 2 * L] += m * p16
            T[i + 1] += T[i] >> 16
        t = T[2 * L:]
        # pair 16-bit positions into 32-bit ones (< 2^57), then one ripple
        # of (t, t - p) stacked: value(t) < 2p, pick t - p when >= 0
        w = t[0:2 * L:2] + (t[1:2 * L:2] << 16)
        w = torch.cat([w, t[2 * L:]])
        p = torch.tensor(self.p_limbs + [0], dtype=torch.int64,
                         device=w.device).reshape((L + 1,) + (1,) * (w.dim() - 1))
        (lo, hi), carry = _ripple(torch.stack([w, w - p]), 1)
        return narrow(torch.where(carry[1] < 0, lo, hi)[:L], dtype)

    def to_mont(self, a):
        return self.mont_mul(a, self.const(self.r2, (1,) * (a.dim() - 1),
                                           a.device, a.dtype))

    def from_mont(self, a):
        return self.mont_mul(a, self.const(1, (1,) * (a.dim() - 1),
                                           a.device, a.dtype))

    # -- inversion ---------------------------------------------------------

    def _host_inv_mont(self, total):
        """One Montgomery-domain inverse of a [8, 1] tensor, on the host:
        inv(xR) = x^-1 R, inv(0) = 0.  A Fermat chain would be ~380
        dependent multiplies of one lane, each a chain of tensor ops."""
        v = planes_to_ints(total)[0]
        inv = 0 if v == 0 else pow(v, -1, self.p) * self.r * self.r % self.p
        return self.const(inv, (1,), total.device, total.dtype)

    def batch_inv_mont(self, a, mul=None):
        """Montgomery-trick batch inversion (Montgomery domain): prefix and
        suffix products by log-depth scans, ONE inversion of the total.
        inv(0) = 0 (zero lanes are masked to one for the scans).  `mul`
        (default: this module's `mont_mul`) multiplies two contiguous
        [8, n] arrays, or an [8, n] array by an [8, 1] one; the Fr callers
        pass `kernels.fr_mont_mul`."""
        mul = mul or self.mont_mul
        shape = a.shape
        flat = a.reshape(L, -1)
        n = flat.shape[1]
        zero = self.is_zero(flat)
        one = self.one_mont((n,), a.device, a.dtype)
        x = torch.where(zero, one, flat)
        pre = _scan(mul, x, reverse=False)
        suf = _scan(mul, x, reverse=True)
        tinv = self._host_inv_mont(pre[:, -1:])
        epre = torch.cat([one[:, :1], pre[:, :-1]], dim=1)
        esuf = torch.cat([suf[:, 1:], one[:, :1]], dim=1)
        inv = mul(mul(epre, esuf), tinv)
        inv = torch.where(zero, torch.zeros_like(inv), inv)
        return inv.reshape(shape)


def _split16(a):
    """[8, *b] 32-bit limbs -> [16, *b] 16-bit limbs (int64)."""
    return torch.stack([a & M16, a >> 16], 1).reshape((2 * L,) + a.shape[1:])


def _scan(mul, x, reverse: bool):
    """Inclusive product scan along axis 1 (Hillis-Steele, log2(n) muls)."""
    n = x.shape[1]
    if reverse:
        x = x.flip(1)
    k = 1
    while k < n:
        x = torch.cat([x[:, :k], mul(x[:, k:].contiguous(),
                                     x[:, :-k].contiguous())], dim=1)
        k *= 2
    return x.flip(1) if reverse else x


@functools.cache
def fr() -> FieldOps:
    return FieldOps(FR_MODULUS, "fr")


@functools.cache
def fq() -> FieldOps:
    return FieldOps(FQ_MODULUS, "fq")
