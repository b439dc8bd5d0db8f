"""CUDA-backed Groth16 prover: the twin of the JAX package's
`JaxGroth16Prover` (`ultragroth_tpu/protocol/prover.py:126-253`).

Pipeline (parity: Groth16::Prover::prove, src/groth16.cpp:48-203): limb
split of the witness on the device, four witness MSMs (A, B1, C on G1, B2
on G2), the sparse R1CS scatter, the quotient (three inverse-NTT /
odd-coset / NTT round trips and the H_SCALE product), the H MSM, then the
five points to affine and the host blinding algebra (`finalize_proof`).

This slice runs the NTT in the JAX package's `base` mode, without
fixed-base MSM tables and without a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FQ_MODULUS as Q
from ..ops import kernels
from ..ops import limbs as lb
from ..ops.field import fr
from ..ops.msm import default_window, msm
from ..ops.ntt import Domain, quotient_scalars, scatter_coefs
from ..oracle import field as ofield
from ..trace import Tracer
from .groth16 import (Proof, decode_g1, decode_g2, finalize_proof,
                      random_blinding)


def g1_section_to_planes(arr: np.ndarray, device="cpu"):
    """zkey G1 section [N, 2, 8] u32 Montgomery words -> (table [2, 8, N],
    inf [N]); the zkey writes infinity as (0, 0)."""
    table = lb.words_to_planes(arr.transpose(1, 0, 2), device)   # [8, 2, N]
    inf = (arr.reshape(arr.shape[0], -1) == 0).all(axis=-1)
    return (table.permute(1, 0, 2).contiguous(),
            torch.from_numpy(inf).to(device))


def g2_section_to_planes(arr: np.ndarray, device="cpu"):
    """zkey G2 section [N, 4, 8] -> (table [2, 2, 8, N], inf [N])."""
    n = arr.shape[0]
    table = lb.words_to_planes(arr.transpose(1, 0, 2), device)   # [8, 4, N]
    table = table.permute(1, 0, 2).reshape(2, 2, 8, n).contiguous()
    inf = (arr.reshape(n, -1) == 0).all(axis=-1)
    return table, torch.from_numpy(inf).to(device)


def _xyzz_to_affine_host(words: list, fq2: bool):
    """Montgomery xyzz coordinates (ints) -> oracle affine point or None:
    x = X / ZZ, y = Y / ZZZ (the R factors cancel); ZZ == 0 is infinity."""
    if not fq2:
        x, y, zz, zzz = words
        if zz == 0:
            return None
        return (x * pow(zz, -1, Q) % Q, y * pow(zzz, -1, Q) % Q)
    x, y, zz, zzz = [(words[2 * i], words[2 * i + 1]) for i in range(4)]
    if zz == (0, 0):
        return None
    return (ofield.fq2_mul(x, ofield.fq2_inv(zz)),
            ofield.fq2_mul(y, ofield.fq2_inv(zzz)))


def normalize_outputs(g1_pts, g2_pt):
    """The five MSM outputs -> oracle affine points, with ONE readback.

    The xyzz -> affine step of five points runs on the host, in Python
    integers: on the device it is a chain of dependent multiplies of a
    handful of lanes (a Fermat inversion alone is ~380 of them), which is
    launch-bound.  inv(0) never happens: ZZ == 0 is infinity, None."""
    flat = torch.cat([torch.stack(list(g1_pts)).reshape(-1),
                      g2_pt.reshape(-1)])
    ints = lb.planes_to_ints(flat.reshape(-1, 8).T)
    g1 = [_xyzz_to_affine_host(ints[4 * i:4 * i + 4], False) for i in range(4)]
    g2 = _xyzz_to_affine_host(ints[16:24], True)
    return g1, g2


class TorchGroth16Prover:
    """Keeps the zkey resident on the device; prove() per witness.

    device: "cuda" (the default) or "cpu" (the plain PyTorch versions of
    every kernel; what the CPU tests run)."""

    def __init__(self, zkey, device="cuda"):
        self.zk = zk = zkey
        self.device = torch.device(device)
        self.log_n = zk.domain_size.bit_length() - 1
        if (1 << self.log_n) != zk.domain_size:
            raise ValueError("zkey domain size is not a power of two")
        dev = self.device
        self.points_a = g1_section_to_planes(zk.points_a, dev)
        self.points_b1 = g1_section_to_planes(zk.points_b1, dev)
        self.points_b2 = g2_section_to_planes(zk.points_b2, dev)
        self.points_c = g1_section_to_planes(zk.points_c, dev)
        self.points_h = g1_section_to_planes(zk.points_h, dev)
        self.coef_val_mont = lb.words_to_planes(zk.coef_val, dev)
        self.coef_m = torch.from_numpy(np.asarray(zk.coef_m, np.int64)).to(dev)
        self.coef_c = torch.from_numpy(np.asarray(zk.coef_c, np.int64)).to(dev)
        self.coef_s = torch.from_numpy(np.asarray(zk.coef_s, np.int64)).to(dev)

        # blinding-term points for the host-side finalization
        self.alpha1 = decode_g1(zk.alpha1)
        self.beta1 = decode_g1(zk.beta1)
        self.beta2 = decode_g2(zk.beta2)
        self.delta1 = decode_g1(zk.delta1)
        self.delta2 = decode_g2(zk.delta2)

        self.c_vars = default_window(zk.n_vars)
        self.c_h = default_window(zk.domain_size)
        self.domain = Domain(self.log_n, dev)
        F = fr()
        self._r2 = F.const(F.r2, (1,), dev, lb.limb_dtype(dev))
        self.last_phase_ms: dict | None = None

    @torch.inference_mode()
    def msm_outputs(self, witness_words: np.ndarray, tracer: Tracer):
        """The five MSM results as xyzz points (pi_a, pi_b1, pi_b2, pi_c,
        pi_h); phase names follow the JAX package's."""
        zk, t = self.zk, tracer
        w_std = t.run("upload", lambda: lb.words_to_planes(witness_words,
                                                           self.device))
        pi_a = t.run("msm_a", lambda: msm("g1", *self.points_a, w_std,
                                          self.c_vars))
        pi_b1 = t.run("msm_b1", lambda: msm("g1", *self.points_b1, w_std,
                                            self.c_vars))
        pi_b2 = t.run("msm_b2", lambda: msm("g2", *self.points_b2, w_std,
                                            self.c_vars))
        w_c = w_std[:, zk.n_public + 1:].contiguous()
        pi_c = t.run("msm_c", lambda: msm("g1", *self.points_c, w_c,
                                          self.c_vars))

        def scatter():
            w_mont = kernels.fr_mont_mul(w_std, self._r2)
            return scatter_coefs(w_mont, self.coef_val_mont, self.coef_m,
                                 self.coef_c, self.coef_s, zk.domain_size)

        a, b = t.run("scatter", scatter)
        h_std = t.run("quotient", lambda: quotient_scalars(a, b, self.domain))
        pi_h = t.run("msm_h", lambda: msm("g1", *self.points_h, h_std,
                                          self.c_h))
        return pi_a, pi_b1, pi_b2, pi_c, pi_h

    def prove(self, witness_words: np.ndarray, r: int | None = None,
              s: int | None = None) -> Proof:
        zk = self.zk
        if witness_words.shape[0] != zk.n_vars:
            raise ValueError("Invalid witness length.")
        r = random_blinding() if r is None else r
        s = random_blinding() if s is None else s
        t = Tracer(self.device)
        pi_a, pi_b1, pi_b2, pi_c, pi_h = self.msm_outputs(witness_words, t)
        (a, b1, c_, h), b2 = normalize_outputs((pi_a, pi_b1, pi_c, pi_h),
                                               pi_b2)
        proof = finalize_proof(self, a, b1, b2, c_, h, r, s)
        t.mark("finalize")
        self.last_phase_ms = t.report()
        return proof
