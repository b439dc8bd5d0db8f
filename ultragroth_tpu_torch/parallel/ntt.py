"""Mesh-sharded Fr NTT, the 4-step (Bailey) decomposition: the twin of
the JAX package's `parallel/ntt.py`.  n = n1 * n2 with the n1 axis sharded
over D shards, log_n1 = max(log_n // 2, log2 D):

  view x[j] as M[j1, j2], j = j1 + n1*j2          (columns j1 sharded)
  1. local NTT of size n2 along j2 of each column
  2. local twiddle multiply by w_n^(j1*k2)        (`fr_mont_mul`)
  3. all_to_all: shard g' gets the k2 block g' of every column
  4. local NTT of size n1 along j1
  output read-out: X[k2 + n2*k1], in natural order

The port keeps each shard's block column-major, [8, n2, n1/D] (j2, j1),
the layout of `ops/ntt.py:_ntt_cols`, so the fast mode's `fr_cg_ntt`
columns take it as it is; the base mode runs `fr_butterfly` stages over
rows (`_batched_ntt`).  The inverse's two passes scale by 1/n2 and 1/n1.
Values stay Montgomery; the row bases w^j1 are Montgomery too.

`ntt_sharded` takes and returns the whole [8, n] array on the caller's
device: it cuts the columns out, and gathers the k2 blocks back (across
processes with `all_gather`, so every process holds the result).
"""
from __future__ import annotations

import torch

from ..constants import FR_MODULUS
from ..ops import kernels
from ..ops import ntt as _ntt
from ..ops.field import fr
from ..ops.limbs import limb_dtype
from ..protocol.transcript import root_of_unity
from .mesh import Mesh, all_to_all, gather, on_device, shards, to_device

L = 8


def _row_powers(bases: torch.Tensor, m: int) -> torch.Tensor:
    """bases [8, rows] Montgomery -> [8, m, rows]: bases[r]^k at [:, k, r],
    by log-doubling through `fr_mont_mul`."""
    F = fr()
    p = F.one_mont((1, bases.shape[1]), bases.device, bases.dtype)
    cur = bases[:, None, :].contiguous()
    while p.shape[1] < m:
        p = torch.cat([p, kernels.fr_mont_mul(
            p, cur.expand_as(p).contiguous())], dim=1)
        cur = kernels.fr_mont_mul(cur, cur)
    return p[:, :m].contiguous()


def _batched_ntt(x: torch.Tensor, log_m: int, inverse: bool, mode: str,
                 dom: _ntt.Domain) -> torch.Tensor:
    """NTT along axis 1 of [8, M, CB] Montgomery planes, batched over the
    CB columns, natural order in and out; dom: a Domain of size M on x's
    device.  fast: `_ntt_cols` (`fr_cg_ntt` launches); base: the columns
    as rows, bit reversal, one `fr_butterfly` launch a stage."""
    if mode == "fast":
        out = _ntt._ntt_cols(x, log_m, inverse, dom)
    else:
        rows = x.transpose(1, 2)[:, :, dom.bitrev].contiguous()
        flat = rows.view(L, -1)
        for tw in dom.twiddles[inverse]:
            kernels.fr_butterfly(flat, tw)
        out = rows.transpose(1, 2)
    out = out.contiguous()
    if inverse:
        out = kernels.fr_mont_mul(out.view(L, -1), dom.n_inv).view(out.shape)
    return out


class MeshDomain:
    """The constants of the sharded NTT of size 2^log_n over `mesh[axis]`
    (the twin of the JAX package's lru-cached tables): each shard's Domains
    of sizes n1 and n2 and its twiddle block w_n^(j1*k2), made on first use
    and kept; on `device`, where the whole arrays live, the odd-coset
    powers and H_SCALE of `ops.ntt.Domain`."""

    def __init__(self, log_n: int, mesh: Mesh, axis="data", device=None):
        self.log_n = log_n
        self.sh = sh = shards(mesh, axis)
        d = sh.count
        self.log_n1 = max(log_n // 2, (d - 1).bit_length())
        self.log_n2 = log_n - self.log_n1
        if (1 << self.log_n2) % d:
            raise ValueError(f"a 2^{log_n} NTT cannot be cut over {d} "
                             "shards")
        dev = torch.device(device) if device is not None else sh.devices[0]
        with on_device(dev):
            self.coset = _ntt._powers(root_of_unity(log_n + 1), 1 << log_n,
                                      dev)
        self.h_scale = fr().const(_ntt.H_SCALE, (1,), dev, limb_dtype(dev))
        self._doms: dict = {}
        self._tw: dict = {}

    def domain(self, log_m: int, dev: torch.device) -> _ntt.Domain:
        key = (log_m, dev)
        if key not in self._doms:
            with on_device(dev):
                self._doms[key] = _ntt.Domain(log_m, dev)
        return self._doms[key]

    def twiddles(self, i: int, inverse: bool) -> torch.Tensor:
        """Local shard i's w_n^(j1*k2) [8, n2, n1/D] (k2, j1)."""
        key = (i, inverse)
        if key not in self._tw:
            dev = self.sh.devices[i]
            n1, rows = 1 << self.log_n1, (1 << self.log_n1) // self.sh.count
            lo = (self.sh.first + i) * rows
            w = root_of_unity(self.log_n)
            if inverse:
                w = pow(w, -1, FR_MODULUS)
            with on_device(dev):
                bases = _ntt._powers(w, n1, dev)[:, lo:lo + rows]
                self._tw[key] = _row_powers(bases, 1 << self.log_n2)
        return self._tw[key]


@torch.inference_mode()
def ntt_sharded(a: torch.Tensor, dom: MeshDomain, inverse: bool = False,
                mode: str | None = None) -> torch.Tensor:
    """[8, n] Montgomery planes -> their NTT (inverse: w^-1 and 1/n), the
    n1 axis sharded over the mesh of `dom`; mode: `ops.ntt.ntt_mode` of
    the shards' device."""
    sh = dom.sh
    d = sh.count
    n1, n2 = 1 << dom.log_n1, 1 << dom.log_n2
    rows, k = n1 // d, n2 // d
    if tuple(a.shape) != (L, n1 * n2):
        raise ValueError(f"ntt_sharded: expected {(L, n1 * n2)}, got "
                         f"{tuple(a.shape)}")
    mode = _ntt.ntt_mode(sh.devices[0], mode)
    m = a.reshape(L, n2, n1)                         # M[j1, j2] at [j2, j1]
    sends = []
    for i, dev in enumerate(sh.devices):
        lo = (sh.first + i) * rows
        with on_device(dev):
            x = to_device(m[:, :, lo:lo + rows], dev).contiguous()
            # [8, n2 (k2), rows]
            h = _batched_ntt(x, dom.log_n2, inverse, mode,
                             dom.domain(dom.log_n2, dev))
            h = kernels.fr_mont_mul(h, dom.twiddles(i, inverse))
            # the k2 block g' of this shard's columns, for shard g'
            sends.append(h.view(L, d, k, rows).permute(1, 0, 3, 2)
                         .contiguous())               # [d, 8, rows, k]
    outs = []
    for dev, recv in zip(sh.devices, all_to_all(sh, sends)):
        with on_device(dev):
            z = recv.permute(1, 0, 2, 3).reshape(L, n1, k)   # [8, j1, k2]
            outs.append(_batched_ntt(z, dom.log_n1, inverse, mode,
                                     dom.domain(dom.log_n1, dev)))
    full = gather(sh, outs, a.device)                # [d, 8, n1, k]
    # X[k2 + n2*k1]: k1 rows, the shards' k2 blocks side by side
    return full.permute(1, 2, 0, 3).reshape(L, n1 * n2).contiguous()


def to_odd_coset_sharded(vals: torch.Tensor, dom: MeshDomain,
                         mode: str | None = None) -> torch.Tensor:
    """Sharded twin of `ops.ntt.to_odd_coset`: ifft -> w_2n^i -> fft."""
    coeffs = ntt_sharded(vals, dom, inverse=True, mode=mode)
    return ntt_sharded(kernels.fr_mont_mul(coeffs, dom.coset), dom,
                       mode=mode)


@torch.inference_mode()
def quotient_scalars_sharded(a: torch.Tensor, b: torch.Tensor,
                             dom: MeshDomain,
                             mode: str | None = None) -> torch.Tensor:
    """Sharded twin of `ops.ntt.quotient_scalars`: the six NTT passes of
    the H(x) pipeline as 4-step mesh NTTs; the pointwise products on the
    arrays' device."""
    F = fr()
    mul = kernels.fr_mont_mul
    c = mul(a, b)
    a2 = to_odd_coset_sharded(a, dom, mode)
    b2 = to_odd_coset_sharded(b, dom, mode)
    c2 = to_odd_coset_sharded(c, dom, mode)
    h = F.sub(mul(a2, b2), c2)
    return mul(h.contiguous(), dom.h_scale)
