"""The work a prove's MSMs need, and the least time the chip could take
for it: the yardstick of the kernels' roofline shares.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores is 33.5e12
fused multiply-adds a second, and the int32 pipes run half as many:
16.75e12 multiply-adds a second.  A 32 x 32 -> 64-bit product is two of
them, so one 8-limb Montgomery product of Fq is 8 (16 + 1 + 16) = 264.

The bucket accumulation ("drain") of an MSM over n points at window c
does one mixed addition (8 Fq products and 2 squarings; Fq2 products are
3, squarings 2) for every nonzero signed c-bit digit of every scalar: the
work these inputs need.  Its bytes: each point and each sorted entry (4
B a window) read once, each lane's accumulator written once.  The
reduction of each window's 2^(c-1) buckets and the window combine are
counted by their adds and doublings (`reduce_work`); complete adds are 12
products and 2 squarings, doublings 6 and 3.

The window c, the signed-digit recode and the sub-lane split of the top
windows follow the program's MSM as it stands (a copy of its arithmetic,
not an import): a program that changed them changes the work this counts.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
MUL_IMAD = 264
SCALAR_BITS = 254
from .reference.curve import R


def window(n: int) -> int:
    if n >= 1 << 22:
        return 16
    if n >= 1 << 16:
        return 13
    if n >= 1 << 12:
        return 10
    return 8


def n_windows(c: int) -> int:
    return -(-SCALAR_BITS // c) + (1 if SCALAR_BITS % c == 0 else 0)


def split_factor(w: int, c: int) -> int:
    """Sub-lanes a bucket of window w (the top windows' few buckets)."""
    n_buckets = 1 << (c - 1)
    top = (R - 1) >> (c * w)
    if top + 1 >= n_buckets:
        return 1
    return max(1, n_buckets // (1 << (top + 1).bit_length()))


def nonzero_digits(s: torch.Tensor, c: int) -> int:
    """Nonzero signed c-bit digits of standard-form scalars [16, n] (16-bit
    limbs): d + carry = d' + 2^c carry', d' in (-2^(c-1), 2^(c-1)]."""
    half, mask = 1 << (c - 1), (1 << c) - 1
    carry = torch.zeros_like(s[0])
    total = 0
    for w in range(n_windows(c)):
        bit0 = w * c
        limb, off = divmod(bit0, 16)
        v = torch.zeros_like(s[0])
        for k in range(3):
            if limb + k < 16:
                v |= s[limb + k] << (16 * k)
        d = ((v >> off) & mask) + carry
        neg = d > half
        total += int(((torch.where(neg, (1 << c) - d, d)) != 0).sum())
        carry = neg.long()
    return total


def _fq(group: str):
    """(Fq products, squarings) cost in multiply-adds, coordinate words."""
    if group == "g1":
        return MUL_IMAD, MUL_IMAD, 1
    return 3 * MUL_IMAD, 2 * MUL_IMAD, 2


def drain_bound_s(group: str, steps: int, n_points: int, c: int) -> float:
    mul, sqr, kq = _fq(group)
    w = n_windows(c)
    lanes = w << (c - 1)
    ops = steps * (8 * mul + 2 * sqr)
    nbytes = (n_points * 2 * kq * 32 + w * n_points * 4
              + lanes * (12 + 4 * kq * 32))
    return max(nbytes / HBM_BYTES_PER_S, ops / IMAD_PER_S)


def reduce_work(m: int, splits) -> tuple[int, int]:
    """(complete adds, doublings) of the reduction of windows of m
    buckets, window w in splits[w] sub-lanes a bucket: pairwise folds
    level by level, a bank of negated even halves each level after the
    pre-folds, and the banks summed by doubling at the end."""
    adds = dbls = 0
    for s in splits:
        u, arrays, pre = m, 1, s.bit_length() - 1
        while u > 1:
            adds += arrays * (u // 2)
            if pre:
                pre -= 1
            else:
                arrays += 1
            u //= 2
        adds += arrays - 1
        dbls += arrays - 1
    return adds, dbls


def reduce_bound_s(group: str, c: int) -> float:
    """The reduction and the window combine of one MSM."""
    mul, sqr, kq = _fq(group)
    w = n_windows(c)
    m = 1 << (c - 1)
    adds, dbls = reduce_work(m, [split_factor(i, c) for i in range(w)])
    adds += w - 1                           # the combine's fold
    dbls += c * w * (w - 1) // 2            # window i doubled c i times
    ops = adds * (12 * mul + 2 * sqr) + dbls * (6 * mul + 3 * sqr)
    point = 4 * kq * 32
    nbytes = point * w * (m + 1) + point * (w + 1)
    return max(nbytes / HBM_BYTES_PER_S, ops / IMAD_PER_S)


def prove_bounds(sections: dict, scalars: dict) -> dict:
    """{'drain': s, 'reduce': s}: the bound of one prove's MSMs.
    sections: name -> (group, ...); scalars: name -> [16, n]."""
    out = {"drain": 0.0, "reduce": 0.0}
    for name, s in scalars.items():
        group = sections[name][0]
        n = s.shape[1]
        if n == 0:
            continue
        c = window(n)
        out["drain"] += drain_bound_s(group, nonzero_digits(s, c), n, c)
        out["reduce"] += reduce_bound_s(group, c)
    return out
