"""Fr NTT on limb planes + the Groth16 quotient (H) pipeline.

The twin of the JAX package's `ops/ntt.py` in its `base` mode (the
per-stage NTT, `ULTRAGROTH_NTT=base`): a bit-reversal gather, then one
`fr_butterfly` kernel launch per DIT stage, applied in place, and the 1/n
scale of the inverse through `fr_mont_mul`.  Values stay in the Montgomery
domain end to end.  The constant-geometry kernel of the `fast` mode
(`_cg_kernel_call`) is not ported yet.

Twiddle tables, coset powers and the constants the quotient needs are
made once per (log_n, device) by a `Domain`, on the device, by
log-doubling through `fr_mont_mul`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FR_MODULUS
from ..protocol.quotient import H_SCALE
from ..protocol.transcript import root_of_unity
from . import kernels
from .field import fr
from .field import _ripple
from .limbs import limb_dtype, narrow, widen

L = 8


def _powers(base_int: int, m: int, device) -> torch.Tensor:
    """[8, m] Montgomery planes of base^0 .. base^(m-1), by log-doubling."""
    F = fr()
    dtype = limb_dtype(device)
    p = F.one_mont((1,), device, dtype)
    cur = F.const(base_int * F.r, (1,), device, dtype)
    while p.shape[1] < m:
        p = torch.cat([p, kernels.fr_mont_mul(p, cur)], dim=1)
        cur = kernels.fr_mont_mul(cur, cur)
    return p[:, :m].contiguous()


def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class Domain:
    """Per-(log_n, device) constants of the NTT and the quotient:
    per-stage twiddles of both directions, 1/n, the odd-coset powers
    w_2n^i and H_SCALE (the twin of the JAX package's lru-cached tables)."""

    def __init__(self, log_n: int, device="cuda"):
        F = fr()
        self.log_n = log_n
        self.device = torch.device(device)
        dtype = limb_dtype(device)
        n = 1 << log_n
        self.bitrev = torch.from_numpy(_bitrev_perm(log_n)).to(self.device)
        self.twiddles = {}
        for inverse in (False, True):
            w = root_of_unity(log_n)
            if inverse:
                w = pow(w, -1, FR_MODULUS)
            # stage s (block length 2^s) uses powers of w^(n / 2^s)
            self.twiddles[inverse] = [
                _powers(pow(w, 1 << (log_n - s), FR_MODULUS), 1 << (s - 1),
                        device)
                for s in range(1, log_n + 1)]
        self.n_inv = F.const(pow(n, -1, FR_MODULUS) * F.r, (1,), device, dtype)
        self.coset = _powers(root_of_unity(log_n + 1), n, device)
        # standard-domain H_SCALE: mont_mul by it applies the R^-2 wire
        # scale and leaves standard form (protocol/quotient.py)
        self.h_scale = F.const(H_SCALE, (1,), device, dtype)


@torch.inference_mode()
def ntt(a: torch.Tensor, dom: Domain, inverse: bool = False) -> torch.Tensor:
    """In-order NTT over [8, n] Montgomery planes; returns a new [8, n].

    X_j = sum_k x_k w^{jk} (inverse: w^-1 and the 1/n scale)."""
    n = 1 << dom.log_n
    if tuple(a.shape) != (L, n):
        raise ValueError(f"ntt: expected {(L, n)}, got {tuple(a.shape)}")
    a = a[:, dom.bitrev].contiguous()
    for tw in dom.twiddles[inverse]:
        kernels.fr_butterfly(a, tw)
    if inverse:
        a = kernels.fr_mont_mul(a, dom.n_inv)
    return a


def to_odd_coset(vals: torch.Tensor, dom: Domain) -> torch.Tensor:
    """ifft -> pointwise w_2n^i -> fft (all Montgomery domain)."""
    coeffs = ntt(vals, dom, inverse=True)
    return ntt(kernels.fr_mont_mul(coeffs, dom.coset), dom)


@torch.inference_mode()
def scatter_coefs(witness_mont, coef_val_mont, coef_m, coef_c, coef_s,
                  domain_size: int):
    """Sparse R1CS evaluation: a[c] += w[s] * coef (m selects a or b).

    witness_mont [8, nVars] and coef_val_mont [8, nCoefs] Montgomery planes;
    coef_m/c/s int tensors [nCoefs].  Returns (a, b) [8, domain] Montgomery.

    The products run through `fr_mont_mul`; the sums through `index_add_`
    into int64 accumulators (2^31 addends of 32-bit limbs fit), reduced once
    at the end — the GPU has no scatter limit to dodge, so the JAX
    package's chunked segment_sum is not needed.  Deterministic: integer
    sums do not depend on their order."""
    F = fr()
    dtype = witness_mont.dtype
    prod = kernels.fr_mont_mul(witness_mont[:, coef_s.long()].contiguous(),
                               coef_val_mont)
    seg = coef_m.long() * domain_size + coef_c.long()
    wide = torch.zeros((L, 2 * domain_size), dtype=torch.int64,
                       device=witness_mont.device)
    wide.index_add_(1, seg, widen(prod))
    acc = _redc_carry(wide, dtype)
    return acc[:, :domain_size].contiguous(), acc[:, domain_size:].contiguous()


def _redc_carry(wide: torch.Tensor, dtype) -> torch.Tensor:
    """Reduce int64 limb sums (each < 2^63) mod r, same domain as the
    addends: ripple to 32-bit limbs + a high word h, then
    value = lo + h * 2^256 = from_mont(to_mont(lo)) + to_mont(h)."""
    F = fr()
    lo, hi = _ripple(wide)
    r2 = F.const(F.r2, (1,), wide.device, dtype)
    one = F.const(1, (1,), wide.device, dtype)
    lo = narrow(lo, dtype).contiguous()
    lo_red = kernels.fr_mont_mul(kernels.fr_mont_mul(lo, r2), one)
    hi_planes = torch.zeros_like(lo)
    hi_planes[0] = narrow(hi, dtype)
    return F.add(lo_red, kernels.fr_mont_mul(hi_planes, r2))


@torch.inference_mode()
def quotient_scalars(a: torch.Tensor, b: torch.Tensor,
                     dom: Domain) -> torch.Tensor:
    """Montgomery-domain (a, b) evaluations -> standard-form H MSM scalars:
    h = (A*B - C) on the odd coset with the R^-2 wire scale folded into the
    final product (parity: protocol/quotient.py:quotient_evals)."""
    F = fr()
    mul = kernels.fr_mont_mul
    c = mul(a, b)
    a2 = to_odd_coset(a, dom)
    b2 = to_odd_coset(b, dom)
    c2 = to_odd_coset(c, dom)
    h = F.sub(mul(a2, b2), c2)
    return mul(h.contiguous(), dom.h_scale)
