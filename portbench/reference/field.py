"""Prime-field arithmetic in plain PyTorch, for the benchmark's own key
generator and its reference prover.

An element batch is an int64 tensor [16, *shape]: sixteen 16-bit limbs,
least significant first, each in [0, 2^16).  Values are kept canonical
(< p) after every operation.  Products are Montgomery products with R =
2^256, the radix the zkey format stores its coordinates in, so a
Montgomery-form batch regrouped into 32-bit words is the zkey's encoding.

Sixteen-bit limbs keep every partial product below 2^32 and every column
sum below 2^40, so int64 holds the schoolbook columns and the word-by-word
reduction without overflow.  Nothing here is fast; it is short and plainly
right, and it runs wherever torch runs.
"""
from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
BITS = 16
MASK = (1 << BITS) - 1
RADIX = 1 << (LIMBS * BITS)          # R = 2^256


def ints_to_u16(values) -> np.ndarray:
    """Python ints (each < 2^256) -> [n, 16] uint16, little-endian limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS)


def u16_to_ints(arr: np.ndarray) -> list:
    """[n, 16] uint16 limbs -> Python ints."""
    raw = np.ascontiguousarray(arr, dtype="<u2").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


class Field:
    """Arithmetic mod an odd prime p < 2^254 on [16, *shape] limb tensors."""

    def __init__(self, p: int, device="cpu"):
        if not p % 2 or p >= RADIX >> 2:
            raise ValueError("Field wants an odd modulus below 2^254")
        self.p = p
        self.device = torch.device(device)
        self.r_mod = RADIX % p                # 1 in Montgomery form
        self.r2 = RADIX * RADIX % p           # to Montgomery form
        self.ninv = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
        self._p = self.tensor([p])            # [16, 1]

    # -- conversion ----------------------------------------------------------

    def tensor(self, values) -> torch.Tensor:
        """Python ints -> [16, n] on the field's device (no reduction)."""
        arr = ints_to_u16(list(values)).astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(arr.T)).to(self.device)

    def from_u16(self, arr: np.ndarray) -> torch.Tensor:
        """[n, 16] uint16 limbs (e.g. 32-byte little-endian words) ->
        [16, n] on the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .astype(np.int64))
        return t.to(self.device).T.contiguous()

    def to_u16(self, x: torch.Tensor) -> np.ndarray:
        """[16, n] -> [n, 16] uint16 on the host."""
        return x.reshape(LIMBS, -1).T.to("cpu").numpy().astype("<u2")

    def to_ints(self, x: torch.Tensor) -> list:
        return u16_to_ints(self.to_u16(x))

    def const(self, value: int, ndim: int = 1) -> torch.Tensor:
        """One element [16, 1, ..., 1] that broadcasts over ndim axes."""
        return self.tensor([value % self.p]).reshape((LIMBS,) + (1,) * ndim)

    # -- carries -------------------------------------------------------------

    @staticmethod
    def _carry(t: torch.Tensor) -> torch.Tensor:
        """Propagate carries (or borrows: >> is arithmetic) from limb 0
        up; the last limb keeps what is left, with its sign."""
        for j in range(t.shape[0] - 1):
            t[j + 1] += t[j] >> BITS
            t[j] &= MASK
        return t

    def _sub_p_if_ge(self, t: torch.Tensor) -> torch.Tensor:
        """t in [0, 2p), normalised -> t mod p."""
        d = self._carry(t - self._p.reshape((LIMBS,) + (1,) * (t.dim() - 1)))
        return torch.where((d[-1] < 0).unsqueeze(0), t, d)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a, b):
        return self._sub_p_if_ge(self._carry(a + b))

    def sub(self, a, b):
        d = self._carry(a - b)
        neg = (d[-1] < 0).unsqueeze(0)
        fixed = self._carry(d + self._p.reshape((LIMBS,) + (1,) * (d.dim() - 1)))
        return torch.where(neg, fixed, d)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product a * b / 2^256 mod p; a, b canonical, or a <
        2^256 with b canonical."""
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape[1:]
        t = torch.zeros((2 * LIMBS + 1,) + tuple(shape), dtype=torch.int64,
                        device=a.device)
        for i in range(LIMBS):
            t[i:i + LIMBS] += a[i] * b
        p = self._p.reshape((LIMBS,) + (1,) * len(shape))
        for i in range(LIMBS):
            m = ((t[i] & MASK) * self.ninv) & MASK
            t[i:i + LIMBS] += m * p
            t[i + 1] += t[i] >> BITS
        out = self._carry(t[LIMBS:2 * LIMBS + 1].clone())
        return self._sub_p_if_ge(out[:LIMBS].clone())

    def to_mont(self, a):
        return self.mul(a, self.const(self.r2, a.dim() - 1))

    def from_mont(self, a):
        return self.mul(a, self.const(1, a.dim() - 1))

    def powers(self, base_mont: torch.Tensor, n: int) -> torch.Tensor:
        """[16, n] Montgomery base^0 .. base^(n-1), by doubling; base_mont
        [16, 1] in Montgomery form."""
        out = self.const(self.r_mod, 1)
        cur = base_mont
        while out.shape[1] < n:
            out = torch.cat([out, self.mul(out, cur)], dim=1)
            cur = self.mul(cur, cur)
        return out[:, :n].contiguous()

    def batch_inv_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Inverses of a [16, n] Montgomery batch (no zero in it), in
        Montgomery form: a product tree up, one host inversion, down."""
        n = x.shape[1]
        size = 1 << max(0, (n - 1).bit_length())
        level = torch.cat([x, self.const(self.r_mod, 1).expand(LIMBS, size - n)],
                          dim=1)
        tree = [level]
        while level.shape[1] > 1:
            level = self.mul(level[:, 0::2], level[:, 1::2])
            tree.append(level)
        root = self.to_ints(level)[0]          # x R mod p; its inverse is R^2/(xR)
        inv = self.tensor([self.r2 * pow(root, -1, self.p) % self.p])
        for below in reversed(tree[:-1]):
            pair = torch.stack([self.mul(inv, below[:, 1::2]),
                                self.mul(inv, below[:, 0::2])], dim=2)
            inv = pair.reshape(LIMBS, -1)
        return inv[:, :n].contiguous()

    def wide_sum(self, acc: torch.Tensor) -> torch.Tensor:
        """Limb sums [16, *shape] (each < 2^62) -> their value mod p,
        canonical: lo + hi * 2^256, hi below 2^48."""
        t = torch.cat([acc, torch.zeros((3,) + tuple(acc.shape[1:]),
                                        dtype=torch.int64,
                                        device=acc.device)])
        t = self._carry(t)
        lo, hi = t[:LIMBS].contiguous(), t[LIMBS:]
        hi16 = torch.zeros_like(lo)
        hi16[:3] = hi
        lo_red = self.from_mont(self.to_mont(lo))
        # hi * R mod p, as a Montgomery product with R^2
        return self.add(lo_red, self.mul(hi16, self.const(self.r2,
                                                          lo.dim() - 1)))


def limb_sum_to_int(sums) -> int:
    """16 int64 limb sums -> the integer sum_j sums[j] * 2^(16 j)."""
    return sum(int(v) << (BITS * j) for j, v in enumerate(sums))
