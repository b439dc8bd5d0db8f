"""CUDA-backed Groth16 and UltraGroth provers: the twins of the JAX
package's `JaxGroth16Prover` and `JaxUltraGrothProver`
(`ultragroth_tpu/protocol/prover.py:126-399`).

Groth16 pipeline (parity: Groth16::Prover::prove, src/groth16.cpp:48-203):
limb split of the witness on the device, four witness MSMs (A, B1, C on
G1, B2 on G2), the sparse R1CS scatter, the quotient (three inverse-NTT /
odd-coset / NTT round trips and the H_SCALE product), the H MSM, then the
five points to affine and the host blinding algebra (`finalize_proof`).

UltraGroth (parity: src/ultra_groth.cpp:401-462) adds round 0 before it:
a G1 MSM over the challenge-independent witness slice, the Fiat-Shamir
challenge on the host (Keccak), and the lookup signals computed and
scattered into the witness on the device (`_lookup_scatter`); its C MSM
runs over the final slice, and `finalize_ultragroth` blinds with the
round and final deltas.

The quotient runs in the mode `ops.ntt.ntt_mode` resolves: the `ntt_mode`
argument, else ULTRAGROTH_NTT, else `fast` on the card and `base` on the
CPU.  Two settings are read once, when a prover is built:
  * the field mode (`ops.mxufield.field_mode()`, ULTRAGROTH_MXU_FIELD): every
    kernel the prover launches, at set-up and in each prove, is of that
    build (`ops.kernels.field_mode`);
  * the fixed-base tables (`_build_fixed_tables`, ULTRAGROTH_FIXED_MSM_MB):
    an MSM whose point set has a table runs `msm_fixed` over it.

With a mesh (`mesh=`, `axis=`; the twin of the JAX provers' arguments)
the point tables are cut over the mesh's shards once, when the prover is
built (`parallel.msm.shard_points`), every MSM runs sharded
(`parallel.msm.msm_sharded`) and the quotient's six NTT passes run as
4-step mesh NTTs (`parallel.ntt.quotient_scalars_sharded`); the
fixed-base tables are off, as in the JAX package, whatever
ULTRAGROTH_FIXED_MSM_MB says.  The proof bytes are the single-device
prover's.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..constants import FQ_MODULUS as Q
from ..ops import kernels
from ..ops import limbs as lb
from ..ops import msm as _msm
from ..ops import mxufield
from ..ops import ntt as _ntt
from ..ops.field import fr
from ..ops.msm import default_window
from ..ops.ntt import Domain, quotient_scalars, scatter_coefs
from ..oracle import curve as oc
from ..oracle import field as ofield
from ..trace import Tracer, profile_session
from .groth16 import (Proof, decode_g1, decode_g2, finalize_proof,
                      random_blinding)
from .ultragroth import derive_challenge, finalize_ultragroth


def g1_section_to_table(arr: np.ndarray, device="cpu"):
    """zkey G1 section [N, 2, 8] u32 Montgomery words -> (the point-major
    table [N, 2, 8] the MSMs read, inf [N]); the zkey writes infinity as
    (0, 0)."""
    inf = (arr.reshape(arr.shape[0], -1) == 0).all(axis=-1)
    return (lb.words_to_tensor(arr, device),
            torch.from_numpy(inf).to(device))


def g2_section_to_table(arr: np.ndarray, device="cpu"):
    """zkey G2 section [N, 4, 8] -> (table [N, 2, 2, 8], inf [N])."""
    n = arr.shape[0]
    inf = (arr.reshape(n, -1) == 0).all(axis=-1)
    return (lb.words_to_tensor(arr, device).reshape(n, 2, 2, 8),
            torch.from_numpy(inf).to(device))


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


def _int_tensor(values, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.int64)).to(device)


FIXED_BYTES_PER_POINT = {"g1": 64, "g2": 128}


def fixed_table_plan(named_points: dict, budget_bytes: float) -> list:
    """Which point sets get a fixed-base table: (bytes, name, group, c) of
    each, largest first, a set taken when it still fits the budget."""
    plan = []
    for name, (group, n) in named_points.items():
        npad = max(64, 1 << (n - 1).bit_length())
        c = _msm.default_fixed_window(npad)
        w = _msm.fixed_n_windows(c)
        plan.append((w * npad * FIXED_BYTES_PER_POINT[group], name, group, c))
    chosen, spend = [], 0
    for entry in sorted(plan, reverse=True, key=lambda t: t[0]):
        if spend + entry[0] <= budget_bytes:
            chosen.append(entry)
            spend += entry[0]
    return chosen


def _build_fixed_tables(**named_points) -> tuple:
    """Fixed-base MSM tables for the per-circuit constant point sets
    (`ops/msm.py:msm_fixed_table`), largest first under a memory budget;
    the twin of the JAX package's `protocol/prover.py:92-125`.

    Opt-in: ULTRAGROTH_FIXED_MSM_MB is the budget in MB (0 / unset = off:
    a table build costs seconds to minutes at 2^20 and the gain is per
    prove, so it belongs to long-lived provers: the server, library
    handles).  named_points: name -> (group, (table, inf)).  Returns
    ({name: (table, inf, c)}, {name: seconds of its build}).  The bytes
    counted are the port's own table's: W * Npad points of 64 B (G1) or
    128 B (G2), 32-bit limbs, point-major, half of the JAX layout's 128 /
    256 B."""
    budget = float(os.environ.get("ULTRAGROTH_FIXED_MSM_MB", "0")) * 1e6
    if budget <= 0:
        return {}, {}
    sizes = {k: (g, pts[1].shape[0]) for k, (g, pts) in named_points.items()}
    out, seconds = {}, {}
    for _, name, group, c in fixed_table_plan(sizes, budget):
        table, inf = named_points[name][1]
        t0 = time.perf_counter()
        out[name] = _msm.msm_fixed_table(group, table, inf, c)
        if table.device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    return out, seconds


class _ResidentKey:
    """What both provers keep on the device: the A, B1, B2 and H point
    tables, the R1CS coefficients, the NTT domain and the window sizes,
    and the optional fixed-base tables."""

    def _load_common(self, zk, device, ntt_mode, mesh, axis):
        self.zk = zk
        self.device = dev = torch.device(device)
        self.mesh, self.axis = mesh, axis
        self.field_mode = mxufield.field_mode()
        self.log_n = zk.domain_size.bit_length() - 1
        if (1 << self.log_n) != zk.domain_size:
            raise ValueError("zkey domain size is not a power of two")
        self.ntt_mode = _ntt.ntt_mode(dev, ntt_mode)
        self.points_a = g1_section_to_table(zk.points_a, dev)
        self.points_b1 = g1_section_to_table(zk.points_b1, dev)
        self.points_b2 = g2_section_to_table(zk.points_b2, dev)
        self.points_h = g1_section_to_table(zk.points_h, dev)
        self.coef_val_mont = lb.words_to_planes(zk.coef_val, dev)
        self.coef_m = _int_tensor(zk.coef_m, dev)
        self.coef_c = _int_tensor(zk.coef_c, dev)
        self.coef_s = _int_tensor(zk.coef_s, dev)
        self.alpha1 = decode_g1(zk.alpha1)
        self.beta1 = decode_g1(zk.beta1)
        self.beta2 = decode_g2(zk.beta2)
        self.c_vars = default_window(zk.n_vars)
        self.c_h = default_window(zk.domain_size)
        F = fr()
        self._r2 = F.const(F.r2, (1,), dev, lb.limb_dtype(dev))
        self.last_phase_ms: dict | None = None

    def _load_tables(self, **point_sets):
        """The NTT domain and the MSMs' tables; point_sets: name -> (group,
        the attribute that holds its (table, inf)).  Without a mesh: the
        fixed-base tables under ULTRAGROTH_FIXED_MSM_MB.  With one: each
        set cut over the mesh's shards, in place of its attribute, and no
        fixed-base table."""
        self.fixed, self.fixed_seconds_by_set = {}, {}
        if self.mesh is not None:
            from ..parallel.msm import shard_points
            from ..parallel.ntt import MeshDomain
            self.domain = MeshDomain(self.log_n, self.mesh, self.axis,
                                     self.device)
            for group, attr in point_sets.values():
                setattr(self, attr, shard_points(
                    group, *getattr(self, attr), self.mesh, self.axis))
            self.fixed_seconds = 0.0
            return
        self.domain = Domain(self.log_n, self.device)
        t0 = time.perf_counter()
        self.fixed, self.fixed_seconds_by_set = _build_fixed_tables(
            **{k: (g, getattr(self, attr))
               for k, (g, attr) in point_sets.items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.fixed_seconds = time.perf_counter() - t0

    def _msm(self, key: str, group: str, pts, scalars, c: int):
        """The MSM of one point set: over its fixed-base table where it has
        one, sharded under a mesh, else the variable-base Pippenger."""
        if key in self.fixed:
            table, inf, cf = self.fixed[key]
            return _msm.msm_fixed(group, table, inf, scalars, cf)
        if self.mesh is not None:
            from ..parallel.msm import msm_sharded
            return msm_sharded(pts, scalars, c)
        return _msm.msm(group, *pts, scalars, c)

    def _quotient(self, a, b):
        if self.mesh is not None:
            from ..parallel.ntt import quotient_scalars_sharded
            return quotient_scalars_sharded(a, b, self.domain, self.ntt_mode)
        return quotient_scalars(a, b, self.domain, self.ntt_mode)

    def _final_round(self, t: Tracer, w_std, points_c, w_c, c_c, key_c):
        """A, B1, B2 over the whole witness, C over `w_c`, the scatter, the
        quotient and H: the five MSM results as xyzz points."""
        zk = self.zk
        pi_a = t.run("msm_a", lambda: self._msm("a", "g1", self.points_a,
                                                w_std, self.c_vars))
        pi_b1 = t.run("msm_b1", lambda: self._msm("b1", "g1", self.points_b1,
                                                  w_std, self.c_vars))
        pi_b2 = t.run("msm_b2", lambda: self._msm("b2", "g2", self.points_b2,
                                                  w_std, self.c_vars))
        pi_c = t.run("msm_c", lambda: self._msm(key_c, "g1", points_c, w_c,
                                                c_c))

        def scatter():
            w_mont = kernels.fr_mont_mul(w_std, self._r2)
            return scatter_coefs(w_mont, self.coef_val_mont, self.coef_m,
                                 self.coef_c, self.coef_s, zk.domain_size)

        a, b = t.run("scatter", scatter)
        h_std = t.run("quotient", lambda: self._quotient(a, b))
        pi_h = t.run("msm_h", lambda: self._msm("h", "g1", self.points_h,
                                                h_std, self.c_h))
        return pi_a, pi_b1, pi_b2, pi_c, pi_h


class TorchGroth16Prover(_ResidentKey):
    """Keeps the zkey resident on the device; prove() per witness.

    device: "cuda" (the default) or "cpu" (the plain PyTorch versions of
    every kernel; what the CPU tests run).  ntt_mode: "fast", "base" or
    None, resolved by `ops.ntt.ntt_mode`.  The field mode and the
    fixed-base tables are read from the environment here, once.  mesh:
    an optional `parallel.Mesh`; the MSMs and the quotient then run sharded
    over `mesh[axis]` (a name or a tuple of names), the whole arrays on
    `device`."""

    def __init__(self, zkey, device="cuda", ntt_mode: str | None = None,
                 mesh=None, axis="data"):
        self._load_common(zkey, device, ntt_mode, mesh, axis)
        self.points_c = g1_section_to_table(zkey.points_c, self.device)
        # blinding-term points for the host-side finalization
        self.delta1 = decode_g1(zkey.delta1)
        self.delta2 = decode_g2(zkey.delta2)
        with kernels.field_mode(self.field_mode):
            self._load_tables(a=("g1", "points_a"), b1=("g1", "points_b1"),
                              b2=("g2", "points_b2"), c=("g1", "points_c"),
                              h=("g1", "points_h"))

    @torch.inference_mode()
    def msm_outputs(self, witness_words: np.ndarray, tracer: Tracer):
        """The five MSM results as xyzz points (pi_a, pi_b1, pi_b2, pi_c,
        pi_h); phase names follow the JAX package's."""
        with kernels.field_mode(self.field_mode):
            w_std = tracer.run("upload", lambda: lb.words_to_planes(
                witness_words, self.device))
            w_c = w_std[:, self.zk.n_public + 1:].contiguous()
            return self._final_round(tracer, w_std, self.points_c, w_c,
                                     self.c_vars, "c")

    def prove(self, witness_words: np.ndarray, r: int | None = None,
              s: int | None = None, abort_check=None) -> Proof:
        """abort_check: optional callable polled at every phase mark; when
        it returns True the prove stops with `trace.ProveAborted`."""
        zk = self.zk
        if witness_words.shape[0] != zk.n_vars:
            raise ValueError("Invalid witness length.")
        r = random_blinding() if r is None else r
        s = random_blinding() if s is None else s
        t = Tracer(self.device, "groth16-prove", abort_check)
        with profile_session("groth16-prove"):
            pi_a, pi_b1, pi_b2, pi_c, pi_h = self.msm_outputs(witness_words,
                                                              t)
            (a, b1, c_, h), b2 = normalize_outputs((pi_a, pi_b1, pi_c, pi_h),
                                                   pi_b2)
            proof = finalize_proof(self, a, b1, b2, c_, h, r, s)
            t.mark("finalize")
        self.last_phase_ms = t.report()
        return proof


class TorchUltraGrothProver(_ResidentKey):
    """The 2-round lookup prover; keeps the zkey resident on the device.

    The heavy phases (six MSMs, the lookup inversion, the quotient NTTs)
    run on the device; the Keccak challenge and the O(1) blinding algebra
    on the host.  device, ntt_mode, mesh, axis, the field mode and the
    fixed-base tables as for `TorchGroth16Prover`."""

    def __init__(self, zkey, device="cuda", ntt_mode: str | None = None,
                 mesh=None, axis="data"):
        self._load_common(zkey, device, ntt_mode, mesh, axis)
        zk, dev = zkey, self.device
        self.round_points_c = g1_section_to_table(zk.round_points_c, dev)
        self.final_points_c = g1_section_to_table(zk.final_points_c, dev)
        self.round_indexes = _int_tensor(zk.round_indexes, dev)
        self.final_indexes = _int_tensor(zk.final_indexes, dev)
        self.round_delta1 = decode_g1(zk.round_delta1)
        self.final_delta1 = decode_g1(zk.final_delta1)
        self.final_delta2 = decode_g2(zk.final_delta2)
        self.c_round = default_window(len(zk.round_indexes))
        self.c_final = default_window(len(zk.final_indexes))
        with kernels.field_mode(self.field_mode):
            self._load_tables(a=("g1", "points_a"), b1=("g1", "points_b1"),
                              b2=("g2", "points_b2"),
                              rc=("g1", "round_points_c"),
                              fc=("g1", "final_points_c"),
                              h=("g1", "points_h"))

    def _lookup_scatter(self, w_std, lookup, rand: int):
        """compute_lookup on the device (parity: src/ultra_groth.cpp:61-106):
        table (i + rand) mod r for i < T, one batch inversion, prod =
        freq * inv2, inv1 = inv2[chunks]; the push vector [rand | inv1 |
        inv2 | prod] scattered into a copy of w at wtns_indxs.  The Fr
        products run through `fr_mont_mul`; inv(0) = 0, as the oracle's."""
        F = fr()
        dev, dtype = self.device, w_std.dtype
        mul = kernels.fr_mont_mul
        one = F.const(1, (1,), dev, dtype)
        freqs = _int_tensor(lookup.frequencies, dev)
        n_t = freqs.shape[0]
        idx_std = torch.zeros((8, n_t), dtype=torch.int64, device=dev)
        idx_std[0] = torch.arange(n_t, device=dev)
        freq_std = torch.zeros_like(idx_std)
        freq_std[0] = freqs
        rand_std = lb.ints_to_planes([rand], dev)
        table_std = F.add(lb.narrow(idx_std, dtype), rand_std)
        inv2_m = F.batch_inv_mont(mul(table_std, self._r2), mul=mul)
        freq_m = mul(lb.narrow(freq_std, dtype), self._r2)
        prod_std = mul(mul(freq_m, inv2_m), one)
        inv2_std = mul(inv2_m, one)
        inv1_std = inv2_std[:, _int_tensor(lookup.chunks, dev)]
        push = torch.cat([rand_std, inv1_std, inv2_std, prod_std], dim=1)
        w = w_std.clone()
        w[:, _int_tensor(lookup.wtns_indxs, dev)] = \
            push[:, _int_tensor(lookup.push_indxs, dev)]
        return w

    @torch.inference_mode()
    def prove(self, witness_words: np.ndarray, lookup, r0: int | None = None,
              r: int | None = None, s: int | None = None, abort_check=None):
        """lookup: chunks, frequencies, wtns_indxs, push_indxs (a parsed
        .uwtns, `io/wtns.py:parse_wtns`).  Returns (UltraGrothProof, the
        final witness as ints, for `public_signals`).  abort_check as for
        `TorchGroth16Prover.prove`."""
        zk = self.zk
        if witness_words.shape[0] != zk.n_vars:
            raise ValueError("Invalid witness length.")
        r0 = random_blinding() if r0 is None else r0
        r = random_blinding() if r is None else r
        s = random_blinding() if s is None else s
        t = Tracer(self.device, "ultragroth-prove", abort_check)
        with profile_session("ultragroth-prove"), \
                kernels.field_mode(self.field_mode):
            return self._prove(t, witness_words, lookup, r0, r, s)

    def _prove(self, t: Tracer, witness_words, lookup, r0, r, s):
        w_std = lb.words_to_planes(witness_words, self.device)

        def round0():
            w_r = w_std[:, self.round_indexes].contiguous()
            pt = self._msm("rc", "g1", self.round_points_c, w_r, self.c_round)
            d = _xyzz_to_affine_host(lb.planes_to_ints(pt.T), False)
            return oc.g1_add(d, oc.g1_mul(self.final_delta1, r0))

        d = t.run("round0_commit", round0)
        rand = derive_challenge(d)
        w_std = t.run("lookup", lambda: self._lookup_scatter(
            w_std, lookup, rand))
        w_c = w_std[:, self.final_indexes].contiguous()
        pi_a, pi_b1, pi_b2, pi_c, pi_h = self._final_round(
            t, w_std, self.final_points_c, w_c, self.c_final, "fc")
        (a, b1, c_, h), b2 = normalize_outputs((pi_a, pi_b1, pi_c, pi_h),
                                               pi_b2)
        proof = finalize_ultragroth(self, a, b1, b2, c_, h, d, r0, r, s)
        t.mark("finalize")
        self.last_phase_ms = t.report()
        return proof, lb.planes_to_ints(w_std)
