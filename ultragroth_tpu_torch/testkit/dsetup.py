"""Device-side trusted setup: batched fixed-base multiplication and the
scalar pipeline on the card.

The twin of the JAX package's `testkit/dsetup.py`.  The host set-up
(`testkit/setup.py`) runs O(N) Python big-int math and takes hours at
2^18 and beyond; this one gives BIT-IDENTICAL zkey bytes and vk JSON for
the same seed (same RNG draw order, same section layout) with the O(N)
work on the device:

  * Lagrange / coset-Lagrange evaluations at tau: powers of the root by
    log-doubling, one Montgomery-trick batch inversion, Fr products, all
    through `kernels.fr_mont_mul`;
  * per-variable polynomial evaluations A_i/B_i/C_i(tau): one Fr product
    per R1CS record and one `index_add_` into int64 limb accumulators, as
    `ops/ntt.py:scatter_coefs` does;
  * every zkey curve point: the 8-bit windowed fixed-base multiplication
    as one `kernels.curve_fixed_base_mul` launch a run (a section's
    scalars): each lane's 32 window steps with the accumulator in
    registers, the window table staged on chip, and a batch to-affine in
    the kernel.

The host keeps the O(1) work (toxic waste, the vk points) and the byte
shuffling, vectorised in numpy: the records of a circuit of ~2^20 rows
number ~5 * 10^6.  `seconds` on the result gives the time of each part:
records (host R1CS walk), scalars, fixed_base, encode.

Entry points run on `cuda` unless given `device="cpu"` (the plain
versions of every kernel; what the CPU tests run).
"""
from __future__ import annotations

import functools
import random
import time

import numpy as np
import torch

from .. import constants as C
from ..constants import FR_MODULUS as R, FQ_MODULUS as Q, MONT_R
from ..io.binfile import pack_binfile
from ..ops import kernels
from ..ops import limbs as lb
from ..ops.field import fq, fr
from ..ops.ntt import _powers, _redc_carry
from ..protocol.transcript import g1_to_json, g2_to_json, root_of_unity
from .setup import (R1CS, SetupResult, UltraSetupResult, _FixedBase,
                    _domain_size, _enc_g1, _enc_g2, _groth_header_blob)

L = lb.NLIMBS
FB_WINDOWS = 32
FB_CHUNK = 1 << 20
"""Lanes per fixed-base call on the CPU: bounds the int64 temporaries of
the plain version's to_affine (16 x 16-bit partial products per limb
product).  On the card a run is one launch, whatever its lanes."""


class _Clock:
    """Seconds by part; synchronises the device at each boundary."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds: dict = {}

    @staticmethod
    def _sync(cuda):
        if cuda:
            torch.cuda.synchronize()

    def part(self, name, fn):
        self._sync(self.cuda)
        t0 = time.perf_counter()
        out = fn()
        self._sync(self.cuda)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)
        return out


# ---------------------------------------------------------------------------
# Fr helpers (Fr products through the fr_mont_mul kernel)
# ---------------------------------------------------------------------------

def _mul(a, b):
    return kernels.fr_mont_mul(a.contiguous(), b.contiguous())


def _mont_const(v: int, device) -> torch.Tensor:
    """[8, 1] Montgomery form of the standard value v."""
    return fr().const(v % R * MONT_R % R, (1,), device,
                      lb.limb_dtype(device))


def _from_mont(a):
    return _mul(a, fr().const(1, (1,), a.device, a.dtype))


def _batch_inv(a):
    return fr().batch_inv_mont(a.contiguous(), mul=kernels.fr_mont_mul)


# ---------------------------------------------------------------------------
# fixed-base tables (host-built once per group, oracle math; ~16K adds)
# ---------------------------------------------------------------------------

@functools.cache
def _fb_oracle(group: str) -> _FixedBase:
    from ..oracle import curve as oc
    if group == "g1":
        return _FixedBase(oc.G1, oc.g1_add)
    return _FixedBase(oc.G2, oc.g2_add)


@functools.cache
def _fb_table_host(group: str):
    """The 32 x 256 window table, entry 256*w + d = d * 256^w * G, as
    Montgomery affine planes [2, 8, 8192] (G1) or [2, 2, 8, 8192] (G2),
    int64, and the infinity mask [8192] (the d == 0 entries)."""
    pts = [p for row in _fb_oracle(group).tables for p in row]
    inf = torch.tensor([p is None for p in pts])

    def planes(coord):
        return lb.ints_to_planes([0 if p is None else coord(p) * MONT_R % Q
                                  for p in pts])

    if group == "g1":
        table = torch.stack([planes(lambda p: p[0]), planes(lambda p: p[1])])
    else:
        table = torch.stack([
            torch.stack([planes(lambda p, i=i, k=k: p[i][k]) for k in range(2)])
            for i in range(2)])
    return table, inf


def _fb_table(group: str, device):
    table, inf = _fb_table_host(group)
    dev = torch.device(device)
    return (lb.narrow(table, lb.limb_dtype(dev)).to(dev).contiguous(),
            inf.to(dev))


def _fb_run(group: str, scalars_std: torch.Tensor, device):
    """Batched fixed-base multiplication: standard-form scalars [8, N] ->
    Montgomery affine (x, y, inf); one `curve_fixed_base_mul` launch on
    the card, calls of FB_CHUNK lanes on the CPU."""
    table, tinf = _fb_table(group, device)
    n = scalars_std.shape[1]
    step = max(n, 1) if table.is_cuda else FB_CHUNK
    parts = [kernels.curve_fixed_base_mul(
        group, table, tinf, scalars_std[:, a:a + step].contiguous())
        for a in range(0, max(n, 1), step)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p, -1) for p in zip(*parts))


# ---------------------------------------------------------------------------
# wire encode (vectorised twin of setup._enc_g1/_enc_g2 section loops)
# ---------------------------------------------------------------------------

def _g1_section_bytes(aff) -> bytes:
    x, y, inf = aff
    words = np.stack([lb.planes_to_words(x), lb.planes_to_words(y)],
                     axis=1)                                   # [N, 2, 8]
    words[inf.cpu().numpy()] = 0
    return words.astype("<u4").tobytes()


def _g2_section_bytes(aff) -> bytes:
    x, y, inf = aff
    words = np.stack([lb.planes_to_words(c)
                      for c in (x[0], x[1], y[0], y[1])], axis=1)  # [N, 4, 8]
    words[inf.cpu().numpy()] = 0
    return words.astype("<u4").tobytes()


def _affine_json_g1(aff) -> list:
    """Montgomery affine planes -> snarkjs-style IC json list."""
    x, y, inf = aff
    F = fq()
    xs = lb.planes_to_ints(F.from_mont(x))
    ys = lb.planes_to_ints(F.from_mont(y))
    infs = inf.cpu().tolist()
    return [g1_to_json(None if infs[i] else (xs[i], ys[i]))
            for i in range(len(xs))]


# ---------------------------------------------------------------------------
# R1CS records (host, numpy)
# ---------------------------------------------------------------------------

class _Records:
    """Every (matrix, row, var, coef) of the R1CS, row-major and A, B, C
    in turn within a row (the order of setup._coefs_blob).  Values are
    kept as indices into the distinct coefficients `uniq` (reduced mod r):
    a circuit has few distinct coefficients and millions of records."""

    def __init__(self, rows):
        counts, ss, vs = [], [], []
        for row in rows:
            for d in row:
                counts.append(len(d))
                ss.extend(d)
                vs.extend(d.values())
        counts = np.asarray(counts, np.int64)
        n_rows = len(rows)
        self.m = np.repeat(np.tile(np.arange(3, dtype=np.int64), n_rows),
                           counts)
        self.c = np.repeat(np.repeat(np.arange(n_rows, dtype=np.int64), 3),
                           counts)
        self.s = np.asarray(ss, np.int64)
        index: dict = {}
        self.vidx = np.fromiter((index.setdefault(v % R, len(index))
                                 for v in vs), np.int64, len(vs))
        self.uniq = list(index)

    def uniq_mont_words(self) -> np.ndarray:
        """[U, 8] u32 words of each distinct coefficient, Montgomery form."""
        return lb.ints_to_words([v * MONT_R % R for v in self.uniq])

    def coefs_blob(self, words: np.ndarray) -> bytes:
        """Section 4, byte-identical to setup._coefs_blob: u32 count +
        {m, c, s, coef: 32 B Montgomery} records of the A and B matrices."""
        keep = self.m < 2
        rec = np.empty((int(keep.sum()), 11), dtype="<u4")
        rec[:, 0] = self.m[keep]
        rec[:, 1] = self.c[keep]
        rec[:, 2] = self.s[keep]
        rec[:, 3:] = words[self.vidx[keep]]
        return len(rec).to_bytes(4, "little") + rec.tobytes()


# ---------------------------------------------------------------------------
# device scalar pipeline
# ---------------------------------------------------------------------------

def _lagrange_mont(tau: int, n: int, log_n: int, coset: bool, device):
    """[8, n] Montgomery planes of L_c(tau) (standard domain) or Lc_j(tau)
    (odd coset): x_c / (tau - x_c) * Z(tau) / (n s0^n), x_c = s0 w^c."""
    F = fr()
    w = root_of_unity(log_n)
    s0 = root_of_unity(log_n + 1) if coset else 1
    s0n = pow(s0, n, R)
    zt = (pow(tau, n, R) - s0n) % R
    k = zt * pow(n * s0n % R, -1, R) % R
    xc = _mul(_powers(w, n, device), _mont_const(s0, device))
    inv = _batch_inv(F.sub(_mont_const(tau, device).expand_as(xc), xc))
    return _mul(_mul(xc, inv), _mont_const(k, device))


def _poly_evals_device(recs: _Records, n_vars: int, lag_m, uniq_m):
    """a_t, b_t, c_t [8, n_vars] Montgomery planes: one Fr product per
    record and one index_add_ into int64 limb sums."""
    dev = lag_m.device
    vidx = torch.from_numpy(recs.vidx).to(dev)
    c = torch.from_numpy(recs.c).to(dev)
    prod = _mul(uniq_m[:, vidx], lag_m[:, c])
    seg = torch.from_numpy(recs.m * n_vars + recs.s).to(dev)
    wide = torch.zeros((L, 3 * n_vars), dtype=torch.int64, device=dev)
    wide.index_add_(1, seg, lb.widen(prod))
    out = _redc_carry(wide, lag_m.dtype)
    return out[:, :n_vars], out[:, n_vars:2 * n_vars], out[:, 2 * n_vars:]


def _scaled_std(vals_m, scale: int):
    """from_mont(vals * scale): standard-form scalars for the fixed base."""
    return _from_mont(_mul(vals_m, _mont_const(scale, vals_m.device)))


def _h_scalars_std(tau: int, n: int, log_n: int, delta: int, device):
    """Lc_j(tau) * (tau^n - 1) * R^2 / (-2 delta): setup._h_points'
    scalars (the coset vanishing factor lives in _lagrange_mont's k)."""
    lc_m = _lagrange_mont(tau, n, log_n, True, device)
    zt = (pow(tau, n, R) - 1) % R
    scale = zt * MONT_R % R * MONT_R % R * pow(-2 * delta % R, -1, R) % R
    return _scaled_std(lc_m, scale)


def _device_common(r1cs: R1CS, rng: random.Random, device, clock: _Clock):
    """Mirror of setup._common with device math; same RNG draw order.
    Returns the domain, the toxic waste, the records and the Montgomery
    planes of A_i(tau), B_i(tau) and K_i = beta A_i + alpha B_i + C_i."""
    F = fr()
    n = _domain_size(len(r1cs.rows))
    log_n = n.bit_length() - 1
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    recs = clock.part("records", lambda: _Records(r1cs.rows))
    uniq_words = clock.part("records", recs.uniq_mont_words)

    def scalars():
        uniq_m = lb.words_to_planes(uniq_words, device)
        lag_m = _lagrange_mont(tau, n, log_n, False, device)
        a_m, b_m, c_m = _poly_evals_device(recs, r1cs.n_vars, lag_m, uniq_m)
        k_m = F.add(F.add(_mul(a_m, _mont_const(beta, device)),
                          _mul(b_m, _mont_const(alpha, device))), c_m)
        return a_m, b_m, k_m

    a_m, b_m, k_m = clock.part("scalars", scalars)
    return (n, log_n, tau, alpha, beta, gamma, recs, uniq_words,
            a_m, b_m, k_m)


def groth16_setup_fast(r1cs: R1CS, seed: int = 0,
                       device="cuda") -> SetupResult:
    """Protocol-1 zkey, bit-identical to setup.groth16_setup(r1cs, seed)."""
    rng = random.Random(seed)
    clock = _Clock(device)
    (n, log_n, tau, alpha, beta, gamma, recs, uniq_words,
     a_m, b_m, k_m) = _device_common(r1cs, rng, device, clock)
    delta = rng.randrange(1, R)
    np_pub = r1cs.n_public

    def scalars():
        return dict(
            ic=_scaled_std(k_m[:, :np_pub + 1], pow(gamma, -1, R)),
            a=_from_mont(a_m), b=_from_mont(b_m),
            c=_scaled_std(k_m[:, np_pub + 1:], pow(delta, -1, R)),
            h=_h_scalars_std(tau, n, log_n, delta, device))

    sc = clock.part("scalars", scalars)

    def fixed_base():
        return dict(
            ic=_fb_run("g1", sc["ic"], device), a=_fb_run("g1", sc["a"], device),
            b1=_fb_run("g1", sc["b"], device), b2=_fb_run("g2", sc["b"], device),
            c=_fb_run("g1", sc["c"], device), h=_fb_run("g1", sc["h"], device))

    aff = clock.part("fixed_base", fixed_base)

    def encode():
        g1, g2 = _fb_oracle("g1"), _fb_oracle("g2")
        alpha1, beta1 = g1.mul(alpha), g1.mul(beta)
        beta2, gamma2 = g2.mul(beta), g2.mul(gamma)
        delta1, delta2 = g1.mul(delta), g2.mul(delta)
        hdr = _groth_header_blob(Q, R, r1cs.n_vars, np_pub, n)
        hdr += _enc_g1(alpha1) + _enc_g1(beta1) + _enc_g2(beta2)
        hdr += _enc_g2(gamma2) + _enc_g1(delta1) + _enc_g2(delta2)
        sections = [
            (C.ZKEY_SEC_HEADER, C.GROTH16_PROTOCOL_ID.to_bytes(4, "little")),
            (C.ZKEY_SEC_GROTH_HEADER, bytes(hdr)),
            (C.ZKEY_SEC_IC, _g1_section_bytes(aff["ic"])),
            (C.ZKEY_SEC_COEFS, recs.coefs_blob(uniq_words)),
            (C.ZKEY_SEC_POINTS_A, _g1_section_bytes(aff["a"])),
            (C.ZKEY_SEC_POINTS_B1, _g1_section_bytes(aff["b1"])),
            (C.ZKEY_SEC_POINTS_B2, _g2_section_bytes(aff["b2"])),
            (C.ZKEY_SEC_POINTS_C, _g1_section_bytes(aff["c"])),
            (C.ZKEY_SEC_POINTS_H, _g1_section_bytes(aff["h"])),
        ]
        vk = {
            "protocol": "groth16", "curve": "bn128", "nPublic": np_pub,
            "vk_alpha_1": g1_to_json(alpha1), "vk_beta_2": g2_to_json(beta2),
            "vk_gamma_2": g2_to_json(gamma2), "vk_delta_2": g2_to_json(delta2),
            "IC": _affine_json_g1(aff["ic"]),
        }
        return pack_binfile(C.ZKEY_MAGIC, 1, sections), vk

    zkey, vk = clock.part("encode", encode)
    return SetupResult(
        zkey_bytes=zkey, vk_json=vk,
        taus=dict(tau=tau, alpha=alpha, beta=beta, gamma=gamma, delta=delta),
        seconds=clock.seconds)


def ultragroth_setup_fast(r1cs: R1CS, round_indexes, final_indexes,
                          rand_indx: int, seed: int = 0,
                          device="cuda") -> UltraSetupResult:
    """Protocol-1337 zkey, bit-identical to setup.ultragroth_setup."""
    rng = random.Random(seed)
    clock = _Clock(device)
    (n, log_n, tau, alpha, beta, gamma, recs, uniq_words,
     a_m, b_m, k_m) = _device_common(r1cs, rng, device, clock)
    delta_r = rng.randrange(1, R)
    delta_f = rng.randrange(1, R)
    np_pub = r1cs.n_public
    dev = k_m.device

    def cols(idxs):
        return torch.as_tensor(np.asarray(idxs, np.int64), device=dev)

    def scalars():
        ginv = pow(gamma, -1, R)
        keep = [i for i in range(np_pub + 1) if i != rand_indx]
        return dict(
            ic=_scaled_std(k_m[:, cols(keep)], ginv),
            icr=_scaled_std(k_m[:, rand_indx:rand_indx + 1], ginv),
            a=_from_mont(a_m), b=_from_mont(b_m),
            rc=_scaled_std(k_m[:, cols(round_indexes)], pow(delta_r, -1, R)),
            fc=_scaled_std(k_m[:, cols(final_indexes)], pow(delta_f, -1, R)),
            h=_h_scalars_std(tau, n, log_n, delta_f, device))

    sc = clock.part("scalars", scalars)

    def fixed_base():
        out = {k: _fb_run("g1", v, device) for k, v in sc.items() if k != "b"}
        out["b1"] = _fb_run("g1", sc["b"], device)
        out["b2"] = _fb_run("g2", sc["b"], device)
        return out

    aff = clock.part("fixed_base", fixed_base)

    def encode():
        g1t, g2t = _fb_oracle("g1"), _fb_oracle("g2")
        alpha1, beta1 = g1t.mul(alpha), g1t.mul(beta)
        beta2, gamma2 = g2t.mul(beta), g2t.mul(gamma)
        rd1, rd2 = g1t.mul(delta_r), g2t.mul(delta_r)
        fd1, fd2 = g1t.mul(delta_f), g2t.mul(delta_f)
        extra = (len(round_indexes).to_bytes(4, "little")
                 + len(final_indexes).to_bytes(4, "little")
                 + rand_indx.to_bytes(4, "little"))
        hdr = _groth_header_blob(Q, R, r1cs.n_vars, np_pub, n, extra)
        hdr += _enc_g1(alpha1) + _enc_g1(beta1) + _enc_g2(beta2)
        hdr += _enc_g2(gamma2)
        hdr += _enc_g1(rd1) + _enc_g2(rd2) + _enc_g1(fd1) + _enc_g2(fd2)
        idx_blob = lambda idxs: np.asarray(idxs, dtype="<u4").tobytes()
        sections = [
            (C.ZKEY_SEC_HEADER, C.ULTRAGROTH_PROTOCOL_ID.to_bytes(4, "little")),
            (C.ZKEY_SEC_GROTH_HEADER, bytes(hdr)),
            (C.ZKEY_SEC_IC, _g1_section_bytes(aff["ic"])),
            (C.ZKEY_SEC_COEFS, recs.coefs_blob(uniq_words)),
            (C.ZKEY_SEC_POINTS_A, _g1_section_bytes(aff["a"])),
            (C.ZKEY_SEC_POINTS_B1, _g1_section_bytes(aff["b1"])),
            (C.ZKEY_SEC_POINTS_B2, _g2_section_bytes(aff["b2"])),
            (C.UG_SEC_ROUND_POINTS_C, _g1_section_bytes(aff["rc"])),
            (C.UG_SEC_FINAL_POINTS_C, _g1_section_bytes(aff["fc"])),
            (C.UG_SEC_ROUND_INDEXES, idx_blob(round_indexes)),
            (C.UG_SEC_FINAL_INDEXES, idx_blob(final_indexes)),
            (C.UG_SEC_POINTS_H, _g1_section_bytes(aff["h"])),
        ]
        vk = {
            "protocol": "ultragroth", "curve": "bn128",
            "vk_alpha_1": g1_to_json(alpha1), "vk_beta_2": g2_to_json(beta2),
            "vk_gamma_2": g2_to_json(gamma2),
            "vk_delta_c2_2": g2_to_json(fd2), "vk_delta_c1_2": g2_to_json(rd2),
            "IC": _affine_json_g1(aff["ic"]),
            "IC_rand": _affine_json_g1(aff["icr"])[0],
            "randIdx": rand_indx,
        }
        return pack_binfile(C.ZKEY_MAGIC, 1, sections), vk

    zkey, vk = clock.part("encode", encode)
    return UltraSetupResult(
        zkey_bytes=zkey, vk_json=vk,
        taus=dict(tau=tau, alpha=alpha, beta=beta, gamma=gamma,
                  delta_r=delta_r, delta_f=delta_f),
        seconds=clock.seconds)
