"""Fr NTT on limb planes + the Groth16 quotient (H) pipeline.

The twin of the JAX package's `ops/ntt.py`, in both of its modes
(`ULTRAGROTH_NTT=fast|base`, `ntt_mode`):

  * `base` (`ntt`): a bit-reversal gather, then one `fr_butterfly` kernel
    launch per DIT stage, applied in place;
  * `fast` (`ntt_fast`): the Bailey split of `_ntt_cols` down to columns
    of at most 2^CG_MAX_LOG points, each axis transformed whole by ONE
    `fr_cg_ntt` launch (natural order out), the split's twiddle product
    and transpose folded into the first: a 2^20 transform is two launches
    and nothing between them.

The 1/n scale of the inverse goes through `fr_mont_mul`.  Values stay in
the Montgomery domain end to end.  The default mode is `fast` on a CUDA
tensor, as the JAX package's default on its accelerator, and `base` on
the CPU.  There is no fallback from one mode to the other: a kernel that
fails to build or launch raises.

Twiddle tables, coset powers and the constants the quotient needs are
made per (log_n, device) by a `Domain`, on the device, by log-doubling
through `fr_mont_mul`.
"""
from __future__ import annotations

import os

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


def ntt_mode(device, mode: str | None = None) -> str:
    """The one place the NTT mode is decided: 'fast' (`fr_cg_ntt` columns)
    or 'base' (one launch per stage).  An explicit `mode` wins, then
    ULTRAGROTH_NTT (the twin of the JAX package's `_ntt_mode` switch);
    the default is fast on CUDA, base on the CPU."""
    mode = mode or os.environ.get("ULTRAGROTH_NTT") or (
        "fast" if torch.device(device).type == "cuda" else "base")
    if mode not in ("fast", "base"):
        raise ValueError(f"unknown NTT mode {mode!r}")
    return mode


class Domain:
    """Per-(log_n, device) constants of the NTT and the quotient:
    per-stage twiddles of both directions, 1/n, the odd-coset powers
    w_2n^i and H_SCALE (the twin of the JAX package's lru-cached tables);
    the fast mode's twiddles (`ntt_twiddles`, the Bailey split's
    `split_twiddles`; `cg_twiddles`, the constant-geometry network's, for
    the plain version) are made on first use and kept."""

    def __init__(self, log_n: int, device="cuda"):
        F = fr()
        self.log_n = log_n
        self.device = torch.device(device)
        dtype = limb_dtype(device)
        n = 1 << log_n
        self._pow: dict = {}
        self._split: dict = {}
        self.bitrev = kernels.bitrev_perm(log_n).to(self.device)
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

    def ntt_twiddles(self, log_m: int, inverse: bool) -> torch.Tensor:
        """[8, M/2] Montgomery planes of w^0 .. w^(M/2-1), w the 2^log_m-th
        root (its inverse for the inverse transform): `fr_cg_ntt`'s
        table."""
        key = (log_m, inverse)
        if key not in self._pow:
            w = root_of_unity(log_m)
            if inverse:
                w = pow(w, -1, FR_MODULUS)
            self._pow[key] = _powers(w, 1 << (log_m - 1), self.device)
        return self._pow[key]

    def cg_twiddles(self, log_m: int, inverse: bool) -> torch.Tensor:
        """[log_m, 8, M/2] Montgomery twiddles of the constant-geometry
        network: tw_s[i] = w^((sigma_s(i) mod 2^(s-1)) * (M >> s))."""
        tw = self.ntt_twiddles(log_m, inverse)
        return torch.stack([tw[:, e.to(self.device)]
                            for e in kernels.cg_exponents(log_m)])

    def split_twiddles(self, log_m2: int, log_m1: int,
                       inverse: bool) -> torch.Tensor:
        """w_M^(k2 * j1) as Montgomery planes [8, M2, M1], M = M1 * M2 (the
        JAX package's `_split_twiddles`).  The split of an M-point
        transform takes it as split_twiddles(log_m1, log_m2): row j1,
        column k2, the layout of its first pass's transposed output."""
        key = (log_m2, log_m1, inverse)
        if key not in self._split:
            m1, m2 = 1 << log_m1, 1 << log_m2
            w = root_of_unity(log_m1 + log_m2)
            if inverse:
                w = pow(w, -1, FR_MODULUS)
            F = fr()
            p = F.one_mont((m2, 1), self.device, limb_dtype(self.device))
            cur = _powers(w, m2, self.device)[:, :, None]   # w^k2
            while p.shape[2] < m1:
                p = torch.cat([p, kernels.fr_mont_mul(
                    p, cur.expand_as(p).contiguous())], dim=2)
                cur = kernels.fr_mont_mul(cur, cur)
            self._split[key] = p[:, :, :m1].contiguous()
        return self._split[key]


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


def _ntt_cols(h: torch.Tensor, log_m: int, inverse: bool,
              dom: Domain) -> torch.Tensor:
    """NTT along axis 1 of [8, M, CB] Montgomery planes, natural order in
    and out, batched over the trailing column axis (the values of the JAX
    package's `_ntt_cols`).  Columns of at most 2^CG_MAX_LOG points go to
    one `fr_cg_ntt` launch; a longer axis is split M = M2 * M1 (j = j2*M1
    + j1, k = k1*M2 + k2) with M2 <= 2^CG_MAX_LOG: one launch makes the
    NTT over j2, the twiddle w_M^(k2*j1) and the transpose to [8, M1, M2,
    CB]; the NTT over j1 follows."""
    if log_m <= kernels.CG_MAX_LOG:
        return kernels.fr_cg_ntt(h.contiguous(), dom.ntt_twiddles(log_m, inverse))
    log_m2 = min(kernels.CG_MAX_LOG, log_m - 1)
    log_m1 = log_m - log_m2
    m1, m2 = 1 << log_m1, 1 << log_m2
    cb = h.shape[2]
    v = kernels.fr_cg_ntt(h.contiguous().reshape(L, m2, m1 * cb),
                          dom.ntt_twiddles(log_m2, inverse),
                          dom.split_twiddles(log_m1, log_m2, inverse), cb)
    v = _ntt_cols(v.reshape(L, m1, m2 * cb), log_m1, inverse, dom)
    return v.reshape(L, m1 * m2, cb)


@torch.inference_mode()
def ntt_fast(a: torch.Tensor, dom: Domain, inverse: bool = False) -> torch.Tensor:
    """Same contract as `ntt`, through `fr_cg_ntt` columns."""
    n = 1 << dom.log_n
    if tuple(a.shape) != (L, n):
        raise ValueError(f"ntt_fast: expected {(L, n)}, got {tuple(a.shape)}")
    out = _ntt_cols(a[:, :, None], dom.log_n, inverse, dom)[:, :, 0]
    if inverse:
        out = kernels.fr_mont_mul(out.contiguous(), dom.n_inv)
    return out.contiguous()


def to_odd_coset(vals: torch.Tensor, dom: Domain, ntt_fn=ntt) -> torch.Tensor:
    """ifft -> pointwise w_2n^i -> fft (all Montgomery domain)."""
    coeffs = ntt_fn(vals, dom, inverse=True)
    return ntt_fn(kernels.fr_mont_mul(coeffs, dom.coset), dom)


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
def quotient_scalars(a: torch.Tensor, b: torch.Tensor, dom: Domain,
                     mode: str | None = None) -> torch.Tensor:
    """Montgomery-domain (a, b) evaluations -> standard-form H MSM scalars:
    h = (A*B - C) on the odd coset with the R^-2 wire scale folded into the
    final product (parity: protocol/quotient.py:quotient_evals).  mode as
    `ntt_mode` resolves it for the tensors' device."""
    F = fr()
    mul = kernels.fr_mont_mul
    f = ntt_fast if ntt_mode(a.device, mode) == "fast" else ntt
    c = mul(a, b)
    a2 = to_odd_coset(a, dom, f)
    b2 = to_odd_coset(b, dom, f)
    c2 = to_odd_coset(c, dom, f)
    h = F.sub(mul(a2, b2), c2)
    return mul(h.contiguous(), dom.h_scale)
