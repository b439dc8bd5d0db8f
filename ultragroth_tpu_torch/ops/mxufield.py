"""The MMA field: Montgomery multiplication with the reduction done as two
constant byte-Toeplitz matrix products.

The twin of the JAX package's `ops/mxufield.py` (`mont_mul_mxu`, :88, the
last TPU kernel), switched by the same variable: ULTRAGROTH_MXU_FIELD=1
(`enabled()`).  On the card the product is `csrc/mma_field.cuh`, built
into every kernel of the `mma` build (`_build.MODES`), with the two
products on the tensor cores as u8 x u8 -> s32 tiles; a prover reads the
flag once, when it is built (`field_mode()`), as the JAX package reads it
once per trace.  This module holds the plain PyTorch version of the same
algorithm, `mont_mul_mma_plain`, which the tests and the checks on the card
hold the kernels against; nothing on a prover's path calls it.

    t    = a * b                        byte-limb schoolbook, 64 positions
    X    = bytes 0..31 of t             (exact bytes: rippled)
    m    = Np[32, 32] @ X mod 2^256     Np[r, c] = byte r-c of -p^-1 mod 2^256
    mp   = Pt[64, 32] @ m               Pt[r, c] = byte r-c of p
    T    = t + mp;  hi = T >> 256 (up to 2^256 + p);  hi - p once if >= p

Byte operands <= 255 and column sums < 2^21, so both products are exact in
any exact arithmetic; here they run as float64 matrix products (exact below
2^53), the CUDA form as integer tensor-core tiles.  Same result as the CIOS
product canonicalised, for a, b < 2^256 with the product bounded as in
CIOS.
"""
from __future__ import annotations

import functools
import os

import torch

from .limbs import narrow, widen


def enabled() -> bool:
    """ULTRAGROTH_MXU_FIELD set to anything but "" or "0"."""
    return os.environ.get("ULTRAGROTH_MXU_FIELD", "") not in ("", "0")


def field_mode() -> str:
    """The kernel build a prover made now runs: `mma` or `cios`."""
    return "mma" if enabled() else "cios"


def _bytes_of(v: int) -> list:
    return [(v >> (8 * k)) & 0xFF for k in range(32)]


def toeplitz(byte_vals: list, rows: int, cols: int = 32) -> torch.Tensor:
    """M[r, c] = byte_vals[r - c] for 0 <= r - c < len(byte_vals), int64."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    d = r - c
    vals = torch.tensor(byte_vals + [0], dtype=torch.int64)
    ok = (d >= 0) & (d < len(byte_vals))
    return torch.where(ok, vals[d.clamp(0, len(byte_vals))], 0)


@functools.cache
def _matrices(p: int):
    nprime = (-pow(p, -1, 1 << 256)) % (1 << 256)
    return (toeplitz(_bytes_of(nprime), 32), toeplitz(_bytes_of(p), 64),
            torch.tensor([(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                         dtype=torch.int64))


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[8, *b] 32-bit limbs (int64) -> [32, *b] bytes."""
    shifts = torch.arange(0, 32, 8, device=x.device).reshape(
        (1, 4) + (1,) * (x.dim() - 1))
    return ((x[:, None] >> shifts) & 0xFF).reshape((32,) + x.shape[1:])


def _ripple(x: torch.Tensor):
    """Carry-save positions [k, *b] (int64, >= 0) -> (bytes [k, *b], the
    carry out of the top position)."""
    out = []
    c = torch.zeros_like(x[0])
    for j in range(x.shape[0]):
        s = x[j] + c
        out.append(s & 0xFF)
        c = s >> 8
    return torch.stack(out), c


def _words(b: torch.Tensor) -> torch.Tensor:
    """[32, *b] bytes -> [8, *b] 32-bit limbs (int64)."""
    b = b.reshape((8, 4) + b.shape[1:])
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _matmul_exact(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Constant [R, 32] int64 matrix @ [32, *b] bytes, exact (float64: every
    entry < 2^21)."""
    flat = x.reshape(32, -1).to(torch.float64)
    out = torch.matmul(m.to(device=x.device, dtype=torch.float64), flat)
    return out.to(torch.int64).reshape((m.shape[0],) + x.shape[1:])


def mont_mul_mma_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b * R^-1) mod p on [8, *batch] limb planes (int32 bit patterns
    or int64), F any FieldOps (its modulus `F.p`); answers in a's dtype."""
    dtype = a.dtype
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    np_m, pt_m, p_words = _matrices(F.p)
    ab, bb = _to_bytes(a), _to_bytes(b)
    # 1. schoolbook over bytes: 64 carry-save positions, entries < 2^21
    t = torch.zeros((64,) + a.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(32):
        t[i:i + 32] += ab[i] * bb
    # 2. X = exact bytes of t mod 2^256; m = Np @ X mod 2^256
    t_bytes, _ = _ripple(t)
    m, _ = _ripple(_matmul_exact(np_m, t_bytes[:32]))
    # 3.-4. T = t + Pt @ m; high half and the carry above it; one subtract
    tt, top = _ripple(t + _matmul_exact(pt_m, m))
    hi = _words(tt[32:])
    p = p_words.to(a.device).reshape((8,) + (1,) * (hi.dim() - 1))
    d = hi - p
    borrow = torch.zeros_like(hi[0])
    limbs = []
    for j in range(8):
        v = d[j] - borrow
        limbs.append(v & 0xFFFFFFFF)
        borrow = (v < 0).long()
    use_sub = (top > 0) | (borrow == 0)
    out = torch.where(use_sub, torch.stack(limbs), hi)
    return narrow(out, dtype)
