"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (plain nvcc), holds every
kernel against its plain PyTorch version on the card, proves a small
circuit whose proof must verify, then proves a square-chain circuit of
2^20 - 8 constraints (domain 2^20) on a synthetic key whose base points
have known discrete logs, and checks each MSM output exactly (the quotient
in the `fast` NTT mode, held against `base` and the plain versions).
Then UltraGroth: the device set-up of small circuits, byte for byte
against the host set-up, and a small proof on the card against the CPU;
then the full-width lookup circuit (domain 2^20, T = 2^16), its key made
by the device set-up on the card, proved, checked with the 5-pairing
verifier and its lookup signals against the oracle's.

Then the entry points and the second field mode: both kernel builds
(`cios` and `mma`, the latter with the Montgomery reduction on the tensor
cores, `csrc/mma_field.cuh`) are held against the plain versions; the
2^20 Groth16 prove runs once more over fixed-base tables
(ULTRAGROTH_FIXED_MSM_MB), its MSMs against their known logs and its proof
against the variable-base one; the 2^20 UltraGroth key is proved through
`api.UltraGrothProver` in the `mma` mode (ULTRAGROTH_MXU_FIELD=1), its proof
equal to the default mode's for pinned randomness and verified by
`api.ultra_groth_verify`; the proof server answers a POSTed 2^20 .uwtns
with a verifying proof and a /cancel mid-prove with `aborted`; and the CLI
sets up, proves and verifies a 2^10 circuit in subprocesses.

The Pippenger bucket loop is one `curve_bucket_drain` launch per MSM: phase
1 prints each drain's registers, spills and resident blocks per SM, phase
2 holds it equal to its plain version over a multi-step drain with the
exceptional lanes and times it per step (random entries: the
`curve_madd_fast` row; every step exceptional: the `curve_madd_signed`
row, the `exceptional` object of the drain's entry in the kernels line),
and phase 7 checks one drain launch per MSM on every path.

After the loop, the MSM's bucket reduction is `curve_bucket_reduce` (one
launch a wide level, one tail launch) and its window combine one
`curve_window_combine` launch: phase 1 prints their registers, spills and
blocks per SM, phase 2 holds them equal to their plain versions at the
2^20 MSMs' shapes (20 windows x 4,096 buckets with the split-32 top
window, the fixed-base row of 65,536 buckets in `msm.FIXED_SPLIT`
sub-lanes each, the combine of 20 windows at c = 13)
and times them beside their bound and their latency floor (dependent
product rounds x one Fq product's latency, measured by a chain of
dependent products), phase 4 times one G1 and one G2 2^20 MSM stage by
stage, and phase 7 checks each path's reduce and combine launches
against the design's count, and no `curve_add_where` on any single-device path (the
fixed-base MSM sorts all windows' entries as one row, so its drain sums
each bucket across the windows and no fold remains).

The fast NTT is `fr_cg_ntt`, two launches a 2^20 transform (the Bailey
split's twiddle product and transpose folded into the first): phase 1
prints its registers, spills and blocks per SM, phase 2 holds both pass
shapes (natural; folded and transposed) equal to the plain version,
forward and inverse, in both builds, and times them (the second in the
row's `folded` object), phase 4 times the 2^20 quotient in both NTT modes, and phase 7 checks 12
launches a prove and a fast quotient's `fr_mont_mul` launches equal to
the base one's (no split-twiddle product).

The per-key point chains are one launch each, ending in a batch
to-affine inside the kernel: the device set-up's fixed-base ladder
(`curve_fixed_base_mul`, one launch a set-up run) and the fixed-base
tables' windows (`curve_window_table`, one launch a point set).  Phase 1
prints their registers, spills and blocks per SM; phase 2 holds them equal
to their plain versions (the ladder at 2^16 + 37 lanes of the set-up's
window table, the table at c = 17 on 4,072 of the 2^20 key's points, with
the edge lanes: zero scalars, zero bytes, r - 1, points at infinity, a
block all at infinity, a ragged last block) and times them at 2^20 lanes;
phase 4b drives the table build as its own path (`fixed_tables_2^20`),
prints its seconds by set and group and checks sampled rows against the
key's known logs, then times one fixed-base G1 and one G2 2^20 MSM stage
by stage (`ops/msm.py:msm_fixed_stages`), each equal to `msm_fixed`'s
output and to its known log; phase 6 drives the UltraGroth set-up as its own path
(`ultragroth_setup_2^20`); phase 7 checks one ladder launch a non-empty
set-up run, one window-table launch a point set and no `add_where` on the
table build, and that no driven path ran the plain `CurveOps.to_affine`
on the card.

The multi-device layer, the C ABI and the native runtime: phase 4c
proves the 2^20 key over `Mesh([cuda:0] * MESH)` (the 'chip' axis on one
card; path `groth16_2^20_mesh`), its proof equal to phase 4's for the
same r, s and its five sharded MSM outputs equal to their known logs,
each MSM's partial points folded by `curve_add_where` (phase 7 checks
log2(MESH) fold launches a MSM there and none on any single-device
path); phase 4d holds the 4-step sharded NTT at 2^20 equal to `ntt_fast`
in both NTT modes (paths `ntt_sharded_2^20`, `..._base`, the latter the
mesh path's `fr_butterfly` launches); phase 6e proves a 2^10 key over a
('host', 'chip') mesh in a child process whose `runtime.configure` forms
a one-rank NCCL group from ULTRAGROTH_COORDINATOR; phase 6f builds the
port's C ABI shim (and the remote client) with g++ and proves the 2^10
key through it, loaded by ctypes (path `capi_2^10`), verified by its
verifier ABI; phase 6g holds the native host runtime's Keccak, repack and
section scan against the Python paths.

One line per phase (name, seconds, pass/fail) is printed as each phase
ends; before the last line come one JSON object with every kernel's
launches (their sum over the driven paths in `launches`, each path's own
count in `launches_by_path`) and its times, and the card's name and power
limit; the last line is {"ok": true, "device": {...}}.  Any failed check
exits non-zero.  Each driven path (the Groth16 2^20 prove, the same prove
in the `base` NTT mode and over fixed-base tables, the 2^20 quotient in
each NTT mode, the UltraGroth set-up and prove, the UltraGroth prove
through the API in the `mma` mode, the mesh prove, the sharded NTTs, the
C ABI prove) runs
with the launch counts set to 0 just before it and read just after; the
`mont_mul_mma` row counts the launches of MMA-built kernels.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

LOG_N = 20                 # full width: domain 2^20, the JAX package's e2e size
SMALL_CONSTRAINTS = 1022   # small verifiable prove: n_vars = domain = 2^10
SEED = 20261017
R_BLIND = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
S_BLIND = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09
R0_BLIND = 0xAAAA567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
# UltraGroth at full width: the JAX package's lookup fixture (bench.py:
# 291-316) at its end-to-end domain.  T = 2^16 (a 16-bit range-check
# table); K chunks fill the rest of the domain: K + 2T + 2 = 2^20 - 6 rows.
UG_TABLE = 1 << 16
UG_CHUNKS = (1 << LOG_N) - (1 << 17) - 8
UG_SMALL = (64, 16)        # chunks, table of the small set-up and prove

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores = 33.5e12 FMA/s, and the int32 pipes issue half
# as many multiply-adds: 16.75e12 IMAD/s.  A 32x32 -> 64-bit product is two
# of them (mad.lo, mad.hi).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
MUL_IMAD = 264             # one 8-limb CIOS product: 8 * (16 + 1 + 16)
# The MMA product (csrc/mma_field.cuh): the 512-bit schoolbook, 128
# multiply-adds, on the int32 pipes; the Toeplitz products it forms, 32 x
# 32 for m and 40 x 32 for the columns 24..63 of m * p = 2,304 u8 MACs (2
# operations each) a lane, on the tensor cores at the dense int8 rate.
MMA_IMAD = 128
MMA_U8_OPS = 2 * 2304
INT8_OPS_PER_S = 1.979e15
FIXED_MSM_MB = "8000"      # all five 2^20 tables: 4 x 1.01 GB G1 + 2.01 GB G2
FB_CHECK_LANES = (1 << 16) + 37   # the ladder held against its plain version
WT_CHECK_LANES = 4096 - 24  # the window table held against its plain version
DRAIN_CHECK_STEPS = 8      # the bucket drain held against its plain version
DRAIN_TIME_STEPS = 256     # the bucket drain timed
# the TPU kernel of the drain's exceptional steps (its KERNELS entry names
# curve_madd_fast)
DRAIN_EXCEPTIONAL_REPLACES = "ultragroth_tpu/ops/kernels.py:77"
MESH = 2                   # the mesh paths' shards: Mesh([cuda:0] * MESH)
# the MSMs of each driven path: (G1, G2) bucket drain launches
PATH_MSMS = {"groth16_2^20": (4, 1), "groth16_2^20_base": (4, 1),
             "groth16_2^20_fixed": (4, 1), "ultragroth_2^20": (5, 1),
             "ultragroth_2^20_steady": (5, 1), "ultragroth_2^20_api_mma": (5, 1),
             "groth16_2^20_mesh": (4 * MESH, MESH)}
# the shards each MSM of a path runs on (its reduce / combine launches are
# one MSM's times this)
PATH_SHARDS = {"groth16_2^20_mesh": MESH}
# add_where at the mesh fold's shape (phase 4c), for the kernels line
MESH_FOLD = {}
# each driven path's MSM windows: path -> (G1 c's, G2 c's, fixed-base),
# filled as the paths run (`msm_windows`)
PATH_WINDOWS = {}
# the device set-up's fixed-base runs (G1, G2): one ladder launch each
FB_RUNS = {}
# the point sets of the 2^20 Groth16 fixed-base tables (G1, G2): one
# window-table launch each
TABLE_SETS = {"fixed_tables_2^20": (4, 1)}
FQ_CHAIN_STEPS = 4096      # the Fq product's latency: a chain this long
# dependent product rounds: a complete add, a doubling, a drain step
ADD_DEPTH, DBL_DEPTH, STEP_DEPTH = 4, 3, 4


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    ok = False
    try:
        yield
        ok = True
    finally:
        print(f"phase {name}: {time.perf_counter() - t0:.3f} s "
              f"{'pass' if ok else 'FAIL'}", flush=True)


def cuda_time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_ms(fn):
    """One call of a plain version after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# synthetic key with known discrete logs (host, Python integers)
# ---------------------------------------------------------------------------

def _g1_ops():
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    return dict(
        add=lambda a, b: (a + b) % Q, sub=lambda a, b: (a - b) % Q,
        mul=lambda a, b: a * b % Q,
        inv_many=lambda xs: _inv_many(xs, lambda a, b: a * b % Q,
                                      lambda a: pow(a, -1, Q), 1),
        words=lambda v: [v])


def _g2_ops():
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q

    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)

    def inv_many(xs):
        norms = _inv_many([(x[0] * x[0] + x[1] * x[1]) % Q for x in xs],
                          lambda a, b: a * b % Q, lambda a: pow(a, -1, Q), 1)
        return [(x[0] * n % Q, -x[1] * n % Q) for x, n in zip(xs, norms)]

    return dict(
        add=lambda a, b: ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q),
        sub=lambda a, b: ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q),
        mul=mul, inv_many=inv_many,
        words=lambda v: [v[0], v[1]])


def _inv_many(xs, mul, inv, one):
    """Montgomery's trick: every inverse for one inversion."""
    pre = []
    acc = one
    for x in xs:
        pre.append(acc)
        acc = mul(acc, x)
    acc = inv(acc)
    out = [None] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = mul(acc, pre[i])
        acc = mul(acc, xs[i])
    return out


def _affine_add_row(o, base, qs):
    """base + q for every q of qs (affine, none infinite, none +-base),
    under one batched inversion."""
    bx, by = base
    invs = o["inv_many"]([o["sub"](q[0], bx) for q in qs])
    out = []
    for (qx, qy), iv in zip(qs, invs):
        lam = o["mul"](o["sub"](qy, by), iv)
        x3 = o["sub"](o["sub"](o["mul"](lam, lam), bx), qx)
        out.append((x3, o["sub"](o["mul"](lam, o["sub"](bx, x3)), by)))
    return out


def section_points(args):
    """Points k_i * G for i < n as zkey words [n, K, 8] (Montgomery form),
    with k_i = o + a*m^2 + b*j^2 for i = 1024 m + j.

    Built as U_m + V_j, U_m = (o + a m^2) G and V_j = (b j^2) G from two
    sequential tables (second differences: one add per entry), every row
    of 1024 sums under one inversion.  The quadratic logs keep signed
    partial sums of a bucket off the next point's log, as a real key's
    random logs do; logs affine in i would make the bucket loop's
    incomplete add meet P == +-Q every few hundred thousand steps."""
    group, o, a, b, n = args
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.oracle import curve as oc
    ops = _g1_ops() if group == "g1" else _g2_ops()
    add, mul = (oc.g1_add, oc.g1_mul) if group == "g1" else (oc.g2_add, oc.g2_mul)
    gen = oc.G1 if group == "g1" else oc.G2

    def quad_table(c0, c2, count):
        """(c0 + c2 t^2) G for t < count."""
        out, cur = [], mul(gen, c0) if c0 else None
        diff, step2 = mul(gen, c2), mul(gen, 2 * c2)     # (2t + 1) c2 G
        for _ in range(count):
            out.append(cur)
            cur = add(cur, diff)
            diff = add(diff, step2)
        return out

    rows = -(-n // 1024)
    us = quad_table(o, a, rows)
    vs = quad_table(0, b, 1024)[1:]                  # V_0 is infinity
    chunks = []
    for m in range(rows):
        row = [us[m]] + _affine_add_row(ops, us[m], vs)
        row = row[:min(1024, n - 1024 * m)]
        flat = [v for p in row for c in p for v in ops["words"](c)]
        chunks.append(b"".join(((v << 256) % Q).to_bytes(32, "little")
                               for v in flat))
    k = 2 if group == "g1" else 4
    return np.frombuffer(b"".join(chunks), dtype="<u4").reshape(n, k, 8)


def known_log_sum(scalars, spec):
    """sum_i s_i * k_i mod r for the section spec (group, o, a, b, n)."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    _, o, a, b, _ = spec
    total_o = total_a = total_b = 0
    for i, s in enumerate(scalars):
        m, j = divmod(i, 1024)
        total_o += s
        total_a += s * m * m
        total_b += s * j * j
    return (o * total_o + a * total_a + b * total_b) % R


def key_specs(seed, log_n=LOG_N):
    """synthetic_zkey's draws from its seed: the witness's first value and
    each section's spec (group, o, a, b, n), point i = k_i * G with k_i =
    o + a*m^2 + b*j^2 (i = 1024 m + j)."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    domain = 1 << log_n
    n_vars = domain - 6
    rng = random.Random(seed)
    v0 = rng.randrange(2, R)
    sizes = {"a": ("g1", n_vars), "b1": ("g1", n_vars), "b2": ("g2", n_vars),
             "c": ("g1", n_vars - 2), "h": ("g1", domain)}
    return v0, {name: (group, rng.randrange(1, R), rng.randrange(1, 1 << 128),
                       rng.randrange(1, 1 << 128), n)
                for name, (group, n) in sizes.items()}


def known_log(spec, i):
    """k_i of section `spec`."""
    _, o, a, b, _ = spec
    m, j = divmod(i, 1024)
    return o + a * m * m + b * j * j


def synthetic_zkey(log_n, seed):
    """A Groth16 key for the square chain of 2^log_n - 8 constraints whose
    base points are known multiples of the generators (`section_points`).
    Returns (zkey, witness words, witness ints, section specs)."""
    from ultragroth_tpu_torch import constants as C
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.io.fieldenc import ints_to_array
    from ultragroth_tpu_torch.io.zkey import Groth16ZKey
    from ultragroth_tpu_torch.oracle import curve as oc
    from ultragroth_tpu_torch.testkit.setup import _enc_g1, _enc_g2

    domain = 1 << log_n
    n_c = domain - 8
    n_vars = n_c + 2
    v0, specs = key_specs(seed, log_n)
    vals = [v0]
    for _ in range(n_c):
        vals.append(vals[-1] * vals[-1] % R)
    w = [1, vals[-1]] + vals[:n_c]
    witness = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in w),
                            dtype="<u4").reshape(n_vars, 8).copy()

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(specs)) as pool:
        pa, pb1, pb2, pc, ph = pool.map(section_points, specs.values())

    rows = np.arange(n_c, dtype=np.uint32)
    coef_m = np.tile(np.array([0, 1], np.uint32), n_c)
    coef_c = np.repeat(rows, 2)
    coef_s = np.repeat(rows + 2, 2)
    one_mont = ints_to_array([(1 << 256) % R])[0]
    coef_val = np.tile(one_mont, (2 * n_c, 1))

    def g1w(k):
        return np.frombuffer(_enc_g1(oc.g1_mul(oc.G1, k)), "<u4").reshape(2, 8)

    def g2w(k):
        return np.frombuffer(_enc_g2(oc.g2_mul(oc.G2, k)), "<u4").reshape(4, 8)

    zk = Groth16ZKey(
        n_vars=n_vars, n_public=1, domain_size=domain, n_coefs=2 * n_c,
        q_prime=C.FQ_MODULUS, r_prime=R,
        alpha1=g1w(7), beta1=g1w(11), beta2=g2w(11), gamma2=g2w(13),
        delta1=g1w(17), delta2=g2w(17),
        coef_m=coef_m, coef_c=coef_c, coef_s=coef_s, coef_val=coef_val,
        ic=np.zeros((2, 2, 8), np.uint32),
        points_a=pa, points_b1=pb1, points_b2=pb2, points_c=pc, points_h=ph)
    return zk, witness, w, specs


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------

def _rand_field(shape, p, gen, dev):
    """Canonical random limbs [..., 8, n] (int32 bit patterns) below p."""
    from ultragroth_tpu_torch.ops import limbs as lb
    x = torch.randint(0, 1 << 32, shape, generator=gen, device=dev,
                      dtype=torch.int64)
    top = lb.int_to_limbs(p)[7]
    x[..., 7, :] %= top
    return lb.narrow(x, torch.int32).contiguous()


def kernel_checks(dev, mode, drain_cache):
    """Every kernel of the `mode` build against its plain version at the
    main path's shapes, timed; the plain versions timed in the cios pass
    only (the same function either way)."""
    from ultragroth_tpu_torch.ops import kernels as K
    with K.field_mode(mode):
        return _kernel_checks(dev, host_time_ms if mode == "cios"
                              else (lambda fn: None), drain_cache)


def _kernel_checks(dev, plain, drain_cache):
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops.curve import curve_ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {}
    lanes = 20 * 4096          # c = 13 at 2^20: 20 windows x 4096 buckets
    table_n = 1 << LOG_N
    fold_n = lanes // 2        # the first reduction level's width

    def err(k, p):
        return int((lb.widen(k) - lb.widen(p)).abs().max())

    def record(name, max_abs, ms, plain_ms, bytes_, imads, **extra):
        b_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        b_ops = imads / IMAD_PER_S * 1e3
        results[name] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None, **extra)
        plain_s = "-" if plain_ms is None else f"{plain_ms:.2f}"
        print(f"  [{K.current_field_mode()}] {name}: err {max_abs} kernel "
              f"{ms:.4f} ms plain {plain_s} ms bound "
              f"{max(b_bytes, b_ops):.4f} ms ({results[name]['bound_by']})",
              flush=True)

    # -- Fr kernels -----------------------------------------------------------
    n = table_n
    a = _rand_field((8, n), R, gen, dev)
    b = _rand_field((8, n), R, gen, dev)
    k = K.fr_mont_mul(a, b)
    p = K.fr_mont_mul_plain(a, b)
    check(torch.equal(k, p), "fr_mont_mul disagrees with its plain version")
    record("fr_mont_mul", err(k, p), cuda_time_ms(lambda: K.fr_mont_mul(a, b), 50),
           plain(lambda: K.fr_mont_mul_plain(a, b)),
           3 * 32 * n, n * MUL_IMAD)
    tw = _rand_field((8, n // 2), R, gen, dev)
    k = K.fr_butterfly(a.clone(), tw)
    p = K.fr_butterfly_plain(a.clone(), tw)
    check(torch.equal(k, p), "fr_butterfly disagrees with its plain version")
    work = a.clone()
    record("fr_butterfly", err(k, p),
           cuda_time_ms(lambda: K.fr_butterfly(work, tw), 50),
           plain(lambda: K.fr_butterfly_plain(work.clone(), tw)),
           2 * 32 * n + 32 * (n // 2), (n // 2) * MUL_IMAD)

    # -- fr_cg_ntt at the shapes ntt_fast gives it at 2^20: [8, 2^10, 2^10]
    #    twice a transform, the first with the split twiddles and stored
    #    transposed (`folded`), the second natural; forward and inverse ---
    from ultragroth_tpu_torch.ops.ntt import Domain
    log_m = K.CG_MAX_LOG
    m, cols = 1 << log_m, table_n >> K.CG_MAX_LOG
    dom = Domain(log_m, dev)
    x = _rand_field((8, m * cols), R, gen, dev).reshape(8, m, cols).contiguous()
    for folded in (False, True):
        for inverse in (False, True):
            tw = dom.ntt_twiddles(log_m, inverse)
            args = ((dom.split_twiddles(log_m, log_m, inverse), 1) if folded
                    else (None, 0))
            k = K.fr_cg_ntt(x, tw, *args)
            p = K.fr_cg_ntt_plain(x, tw, *args)
            kind = "folded" if folded else "natural"
            check(torch.equal(k, p), f"fr_cg_ntt ({kind}, inverse "
                  f"{inverse}) disagrees with its plain version")
        products = K.cg_ntt_products(log_m, cols, args[1])
        record("fr_cg_ntt:folded" if folded else "fr_cg_ntt", err(k, p),
               cuda_time_ms(lambda: K.fr_cg_ntt(x, tw, *args), 50),
               plain(lambda: K.fr_cg_ntt_plain(x, tw, *args)),
               (3 if folded else 2) * 32 * m * cols + tw.numel() * 4,
               products * MUL_IMAD, products=products)
    del dom, x, k, p

    lat_ms = fq_latency(dev, gen)
    results["fq_latency"] = dict(ms=lat_ms)
    print(f"  [{K.current_field_mode()}] Fq product latency (one lane's chain "
          f"of {FQ_CHAIN_STEPS} dependent products): {lat_ms * 1e3:.4f} us",
          flush=True)

    # -- curve kernels ----------------------------------------------------------
    for group in ("g1", "g2"):
        ops = curve_ops(group)
        kq = 1 if group == "g1" else 2
        e = () if group == "g1" else (2,)
        fq_mul = MUL_IMAD * (1 if group == "g1" else 3)   # Fq2: Karatsuba
        fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
        drain_checks(group, gen, dev, record, err, plain, drain_cache, lat_ms)
        acc = _rand_field((4, *e, 8, lanes), Q, gen, dev)
        acc[..., :16] = ops.inf_xyzz((16,), dev, torch.int32)
        a = acc[..., :fold_n].contiguous()
        b = acc[..., fold_n:2 * fold_n].contiguous()
        b[..., 48:64] = a[..., 48:64]                               # P == Q
        b[..., 64:80] = ops.neg(a[..., 64:80])                      # P == -Q
        b[..., 80:96] = ops.inf_xyzz((16,), dev, torch.int32)       # Q == inf
        a[..., 96:112] = ops.inf_xyzz((16,), dev, torch.int32)      # P == inf
        ok = torch.rand(fold_n, generator=gen, device=dev) < 0.95
        ok[:112] = True
        k = K.curve_add_where(group, a, b, ok)
        p = K.curve_add_where_plain(group, a, b, ok)
        check(torch.equal(k, p), f"{group}_add_where disagrees with its "
              "plain version")
        n_ok = int(ok.sum())
        record(f"{group}_add_where", err(k, p),
               cuda_time_ms(lambda: K.curve_add_where(group, a, b, ok), 50),
               plain(lambda: K.curve_add_where_plain(group, a, b, ok)),
               3 * 4 * kq * 32 * fold_n + fold_n,
               n_ok * (12 * fq_mul + 2 * fq_sqr))

        fixed_base_checks(group, gen, dev, record, err, drain_cache)
        window_table_checks(group, gen, dev, record, err, drain_cache)

        reduce_checks(group, gen, dev, record, err, plain, drain_cache, lat_ms)
    return results


def fq_latency(dev, gen):
    """ms of one Fq product in a dependent chain: one warp of lanes, each
    a chain of FQ_CHAIN_STEPS products (the chain checked against its
    plain version over 5 steps)."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.ops import kernels as K
    a = _rand_field((8, 32), Q, gen, dev)
    b = _rand_field((8, 32), Q, gen, dev)
    check(torch.equal(K.fq_mul_chain(a, b, 5), K.fq_mul_chain_plain(a, b, 5)),
          "fq_mul_chain disagrees with its plain version")
    return cuda_time_ms(lambda: K.fq_mul_chain(a, b, FQ_CHAIN_STEPS),
                        5) / FQ_CHAIN_STEPS


def reduce_work(m, splits):
    """(complete adds, doublings, dependent product rounds of the longest
    window) of curve_bucket_reduce over windows of m buckets."""
    adds = dbls = depth = 0
    for s in splits:
        u, arrays, pre, levels = m, 1, s.bit_length() - 1, 0
        while u > 1:
            adds += arrays * (u // 2)
            levels += 1
            if pre:
                pre -= 1
            else:
                arrays += 1
            u //= 2
        adds += arrays - 1
        dbls += arrays - 1
        depth = max(depth, levels * ADD_DEPTH
                    + (arrays - 1) * (ADD_DEPTH + DBL_DEPTH))
    return adds, dbls, depth


def reduce_checks(group, gen, dev, record, err, plain, cache, lat_ms, c=13,
                  w=20, fixed_log=16):
    """curve_bucket_reduce against its plain version at the MSM's shapes:
    the variable-base MSM's 20 windows x 4,096 buckets at c = 13 (the top
    window in 32 sub-lanes a bucket) and the fixed-base MSM's one row of
    65,536 buckets (c = 17) in FIXED_SPLIT sub-lanes each, with buckets at
    infinity, equal buckets,
    P with -P; curve_window_combine at W = 20, c = 13 (the defaults).  Inputs and plain
    results made once (`cache`) for both builds.  Each timed beside its
    bound and its latency floor: dependent product rounds x the measured
    latency of one Fq product (`fq_latency`)."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops.curve import curve_ops
    from ultragroth_tpu_torch.ops.msm import FIXED_SPLIT, _split_factor
    ops = curve_ops(group)
    kq = 1 if group == "g1" else 2
    e = () if group == "g1" else (2,)
    fq_mul = MUL_IMAD * (1 if group == "g1" else 3)
    fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
    add_imads, dbl_imads = 12 * fq_mul + 2 * fq_sqr, 6 * fq_mul + 3 * fq_sqr
    key = f"{group}_reduce"
    if key not in cache:
        shapes = {"": (w, 1 << (c - 1), [_split_factor(i, c) for i in range(w)]),
                  ":fixed": (1, FIXED_SPLIT << fixed_log, [FIXED_SPLIT])}
        entries = {}
        for tag, (nw, nb, splits) in shapes.items():
            acc = _rand_field((4, *e, 8, nw * nb), Q, gen, dev).reshape(
                4, *e, 8, nw, nb)
            inf = ops.inf_xyzz((4,), dev, torch.int32)
            acc[..., 0, :4] = inf                                   # inf + inf
            acc[..., 0, 5] = acc[..., 0, 4]                         # P + P
            acc[..., 0, 7] = ops.neg(acc[..., 0, 6:7])[..., 0]      # P + (-P)
            acc[..., nw - 1, 9] = acc[..., nw - 1, 8]   # sub-lanes P + P
            acc = acc.contiguous()
            want = K.curve_bucket_reduce_plain(group, acc, splits)
            plain_ms = (plain(lambda: K.curve_bucket_reduce_plain(
                group, acc, splits)) if tag == "" else None)
            entries[tag] = (acc, splits, want, plain_ms)
        h = _rand_field((4, *e, 8, w), Q, gen, dev)
        h[..., 4] = ops.inf_xyzz((1,), dev, torch.int32)[..., 0]
        h = h.contiguous()
        cache[key] = (entries, h, K.curve_window_combine_plain(group, h, c),
                      plain(lambda: K.curve_window_combine_plain(group, h, c)))
    entries, h, h_want, h_plain_ms = cache[key]
    for tag, (acc, splits, want, plain_ms) in entries.items():
        k = K.curve_bucket_reduce(group, acc, splits)
        check(torch.equal(k, want), f"{group}_bucket_reduce{tag} disagrees "
              "with its plain version")
        nw, nb = acc.shape[-2:]
        adds, dbls, depth = reduce_work(nb, splits)
        record(f"{group}_bucket_reduce{tag}", err(k, want),
               cuda_time_ms(lambda: K.curve_bucket_reduce(group, acc, splits),
                            20), plain_ms, 4 * kq * 32 * nw * (nb + 1),
               adds * add_imads + dbls * dbl_imads,
               latency_floor_ms=depth * lat_ms, launches_a_call=
               K.bucket_reduce_launches(nb), adds=adds, doublings=dbls,
               product_depth=depth)
    k = K.curve_window_combine(group, h, c)
    check(torch.equal(k, h_want), f"{group}_window_combine disagrees with its "
          "plain version")
    # the fold pads the W sums to m with infinity: an add with infinity
    # selects its other operand, so the function needs W - 1 adds; the
    # latency floor keeps the log2(m) fold rounds
    m = 1 << max(1, (w - 1).bit_length())
    dbls = c * w * (w - 1) // 2
    depth = c * (w - 1) * DBL_DEPTH + (m.bit_length() - 1) * ADD_DEPTH
    record(f"{group}_window_combine", err(k, h_want),
           cuda_time_ms(lambda: K.curve_window_combine(group, h, c), 20),
           h_plain_ms, 4 * kq * 32 * (w + 1),
           (w - 1) * add_imads + dbls * dbl_imads,
           latency_floor_ms=depth * lat_ms, doublings=dbls, adds=w - 1,
           product_depth=depth)


def drain_checks(group, gen, dev, record, err, plain, cache, lat_ms):
    """curve_bucket_drain against its plain version at the MSM's 81,920
    lanes (c = 13 at 2^20) over a 2^20-point point-major table: 8 steps
    from given accumulators and steps [2, 7) from infinity, with lanes at
    infinity, P + P repeated, P + (-P) then on, +Q / -Q alternating (every
    step exceptional) and lanes past their counts.  The inputs and the
    plain results are made once (`cache`) for both builds.  Timed per step
    over 256-step drains: random entries (the `curve_madd_fast` row) and
    +Q / -Q alternating from infinity (the `curve_madd_signed` row)."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops.curve import (curve_ops, table_from_planes,
                                                table_planes)
    ops = curve_ops(group)
    kq = 1 if group == "g1" else 2
    e = () if group == "g1" else (2,)
    fq_mul = MUL_IMAD * (1 if group == "g1" else 3)
    fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
    lanes, table_n = 20 * 4096, 1 << LOG_N
    i32 = dict(device=dev, dtype=torch.int32)

    def lane_major(ent):
        """[steps, lanes] entries -> the MSM's layout: lane i's run at
        i * steps (gidx), stride 1."""
        steps = ent.shape[0]
        return (ent.T.reshape(-1).to(torch.int32).contiguous(),
                torch.arange(lanes, **i32) * steps, torch.ones(lanes, **i32))

    if group not in cache:
        steps = DRAIN_CHECK_STEPS
        table = table_from_planes(_rand_field((2, *e, 8, table_n), Q, gen, dev))
        ent = torch.randint(0, 2 * table_n, (steps, lanes), generator=gen,
                            device=dev)
        cnt = torch.randint(0, steps + 1, (lanes,), generator=gen, device=dev)
        acc = _rand_field((4, *e, 8, lanes), Q, gen, dev)
        pid = ent[0, :64] >> 1
        q = table_planes(table[pid])
        q = ops.affine_to_xyzz(q[0], q[1], torch.zeros(64, dtype=torch.bool,
                                                       device=dev))
        acc[..., :16] = ops.inf_xyzz((16,), dev, torch.int32)     # P == inf
        acc[..., 16:48] = q[..., 16:48]                           # P == Q
        ent[:, 16:32] = pid[16:32] * 2                            # Q, 2Q, 3Q..
        ent[0, 32:48] = pid[32:48] * 2 + 1                        # Q + (-Q)
        acc[..., 48:64] = ops.inf_xyzz((16,), dev, torch.int32)
        ent[:, 48:64] = (pid[48:64] * 2)[None, :] + (
            torch.arange(steps, device=dev) % 2)[:, None]        # +Q, -Q, ..
        cnt[:64] = steps
        cnt[64:80] = 0
        orders, gidx, stride = lane_major(ent)
        cnt = cnt.to(torch.int32).contiguous()
        acc = acc.contiguous()
        args = (table, orders, gidx, stride, cnt)
        want = K.curve_bucket_drain_plain(group, *args, 0, steps, acc)
        want_inf = K.curve_bucket_drain_plain(group, *args, 2, 7)
        check(bool(ops.is_inf(want[..., 48:64]).all()),
              f"{group}: +Q / -Q alternating 8 times is not infinity")
        t_steps = DRAIN_TIME_STEPS
        rand = lane_major(torch.randint(0, 2 * table_n, (t_steps, lanes),
                                        generator=gen, device=dev))
        alt_pid = torch.randint(0, table_n, (lanes,), generator=gen,
                                device=dev)
        alt = lane_major(alt_pid[None, :] * 2 + (
            torch.arange(t_steps, device=dev) % 2)[:, None])
        full = torch.full((lanes,), t_steps, **i32)
        fast_args = (table, *rand, full)
        exc_args = (table, *alt, full)
        cache[group] = dict(
            args=args, acc=acc, want=want, want_inf=want_inf,
            fast=fast_args, exc=exc_args,
            plain_fast=plain(lambda: K.curve_bucket_drain_plain(
                group, *fast_args, 0, 2, acc)),
            plain_exc=plain(lambda: K.curve_bucket_drain_plain(
                group, *exc_args, 0, 2)))
    c = cache[group]
    k = K.curve_bucket_drain(group, *c["args"], 0, DRAIN_CHECK_STEPS,
                             acc=c["acc"])
    k_inf = K.curve_bucket_drain(group, *c["args"], 2, 7)
    check(torch.equal(k, c["want"]) and torch.equal(k_inf, c["want_inf"]),
          f"{group}_bucket_drain disagrees with its plain version")
    max_abs = max(err(k, c["want"]), err(k_inf, c["want_inf"]))
    t_steps = DRAIN_TIME_STEPS
    ms_fast = cuda_time_ms(lambda: K.curve_bucket_drain(
        group, *c["fast"], acc=c["acc"]), 5) / t_steps
    ms_exc = cuda_time_ms(lambda: K.curve_bucket_drain(
        group, *c["exc"]), 5) / t_steps
    per_step = lanes * (4 + 2 * kq * 32)           # an entry and a point
    acc_bytes = 4 * kq * 32 * lanes
    madd = lanes * (8 * fq_mul + 2 * fq_sqr)      # 10 Fq products a lane
    # an exceptional step runs the fast madd and then the complete one
    # (+Q / -Q from infinity takes no doubling): 20 products a lane
    # a lane's serial chain (the skewed lanes of the UltraGroth MSMs): a
    # fast step is STEP_DEPTH dependent product rounds, an exceptional one
    # the fast step's and the complete add's
    for name, ms, plain_ms, acc_io, imads, depth in (
            (f"{group}_bucket_drain", ms_fast, c["plain_fast"], 2, madd,
             STEP_DEPTH),
            (f"{group}_bucket_drain:exceptional", ms_exc, c["plain_exc"], 1,
             2 * madd, STEP_DEPTH + ADD_DEPTH)):
        record(name, max_abs, ms, None if plain_ms is None else plain_ms / 2,
               per_step + (acc_io * acc_bytes + 12 * lanes) / t_steps, imads,
               latency_floor_ms_a_step=depth * lat_ms)


def _timed(fn):
    """(fn(), its ms): one call, the device synchronised around it (the
    plain versions' times of the chains: one cold call, as slow as they
    are)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _edge_scalars(n, gen, dev):
    """Canonical random scalars [8, n] with the CPU tests' edge lanes: 0,
    1, r - 1, zero bytes in several windows, a lone top byte; every lane
    of block 1 (lanes 128-255) zero, a block all at infinity."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops import limbs as lb
    sc = _rand_field((8, n), R, gen, dev)
    sc[:, 128:256] = 0
    edges = [0, 1, R - 1, 0x30 << 248, 1 << 64, 256 ** 31]
    sc[:, :len(edges)] = lb.ints_to_planes(edges, dev).to(torch.int32)
    for k in range(8, 40):                 # byte k % 4 of every limb zero:
        b = k % 4                          # eight windows of zero digits
        mask = int(np.array(~(0xFF << (8 * b)) & 0xFFFFFFFF, np.uint32)
                   .view(np.int32))
        sc[:, k] &= mask
    return sc.contiguous()


def fixed_base_checks(group, gen, dev, record, err, cache):
    """curve_fixed_base_mul against its plain version (32
    curve_madd_valid_plain steps and CurveOps.to_affine) on the device
    set-up's real window table at 2^16 + 37 lanes (a ragged last block),
    with the edge lanes of `_edge_scalars`; timed at 2^20 lanes, the
    set-up's runs' width; the plain version timed once at the check's
    shape (cios pass)."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.testkit.dsetup import _fb_table
    kq = 1 if group == "g1" else 2
    table, tinf = _fb_table(group, dev)
    key = ("fixed_base", group)
    if key not in cache:
        sc = _edge_scalars(FB_CHECK_LANES, gen, dev)
        want, plain_ms = _timed(lambda: K.curve_fixed_base_mul_plain(
            group, table, tinf, sc))
        big = _rand_field((8, 1 << LOG_N), R, gen, dev)
        cache[key] = (sc, want, plain_ms, big)
    sc, want, plain_ms, big = cache[key]
    got = K.curve_fixed_base_mul(group, table, tinf, sc)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{group}_fixed_base_mul disagrees with its plain version")
    check(bool(want[2][128:256].all()) and int(want[2].sum()) == 129,
          f"{group}: the fixed-base infinity lanes are not the zero scalars")
    n = big.shape[1]
    # the work these scalars need: a mixed add of 8 products and 2 squares
    # for every nonzero byte after a lane's first (from infinity the first
    # is a select), and the to-affine's ~6 products a lane
    nz = (big.view(torch.uint8).reshape(8, n, 4) != 0).sum((0, 2))
    adds = int((nz - 1).clamp(min=0).sum())
    fq_mul = MUL_IMAD * (1 if group == "g1" else 3)
    fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
    record(f"{group}_fixed_base_mul", err(got[0], want[0]),
           cuda_time_ms(lambda: K.curve_fixed_base_mul(group, table, tinf, big),
                        5), plain_ms,
           32 * n + (2 * kq * 32 + 1) * n + 2 * kq * 32 * 8192 + 8192,
           adds * (8 * fq_mul + 2 * fq_sqr) + n * 6 * fq_mul,
           lanes=n, adds=adds, plain_lanes=sc.shape[1])


def window_table_checks(group, gen, dev, record, err, cache):
    """curve_window_table against its plain version (curve_add_where_plain
    doublings and CurveOps.to_affine a window) at c = 17 (the 2^20
    tables') on the first 4,072 points of the 2^20 key's A (G1) or B2 (G2)
    section, a ragged last block, with points at infinity among them
    (lanes 0-15 and all of block 1); timed at 2^20 lanes (the key's points
    repeated), the plain version once at the check's shape (cios pass)."""
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops.msm import fixed_n_windows
    c = 17
    nw = fixed_n_windows(c)
    kq = 1 if group == "g1" else 2
    e = (2, 8) if group == "g1" else (2, 2, 8)
    key = ("window_table", group)
    if key not in cache:
        n = WT_CHECK_LANES
        _, specs = key_specs(SEED)
        _, o, a, b, _ = specs["a" if group == "g1" else "b2"]
        words = section_points((group, o, a, b, n))
        base = torch.from_numpy(words.view(np.int32).reshape(n, *e).copy()).to(dev)
        inf = torch.zeros(n, dtype=torch.bool, device=dev)
        inf[:16] = True
        inf[128:256] = True
        base[inf] = 0

        def table_of(pts):
            out = torch.zeros((nw * pts.shape[0], *e), dtype=torch.int32,
                              device=dev)
            out[:pts.shape[0]] = pts
            return out

        want, plain_ms = _timed(lambda: K.curve_window_table_plain(
            group, base, inf, c, table_of(base)))
        big_n = 1 << LOG_N
        big = base[~inf].repeat(big_n // int((~inf).sum()) + 1, 1, *([1] * (len(e) - 1)))
        big = big[:big_n].contiguous()
        cache[key] = (base, inf, want, plain_ms, big, table_of)
    base, inf, want, plain_ms, big, table_of = cache[key]
    got = K.curve_window_table(group, base, inf, c, table_of(base))
    check(torch.equal(got, want), f"{group}_window_table disagrees with its "
          "plain version")
    big_inf = torch.zeros(big.shape[0], dtype=torch.bool, device=dev)
    out = table_of(big)
    n = big.shape[0]
    dbls = (nw - 1) * c * n
    fq_mul = MUL_IMAD * (1 if group == "g1" else 3)
    fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
    record(f"{group}_window_table", err(got, want),
           cuda_time_ms(lambda: K.curve_window_table(group, big, big_inf, c,
                                                     out), 3), plain_ms,
           2 * kq * 32 * n * nw + n,
           dbls * (6 * fq_mul + 3 * fq_sqr) + (nw - 1) * n * 6 * fq_mul,
           lanes=n, c=c, windows=nw, doublings=dbls,
           plain_lanes=base.shape[0])
    del out


@torch.inference_mode()
def _staged(stages):
    """An MSM stage generator (`ops/msm.py:msm_stages`, which `msm`
    itself runs, or `msm_fixed_stages`) run with the device synchronised
    after each stage: {stage: ms between CUDA events}, and the MSM's
    output."""
    events = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        events.append(ev)

    mark()
    names = []
    for name, out in stages:
        mark()
        names.append(name)
    return ({st: events[i].elapsed_time(events[i + 1])
             for i, st in enumerate(names)}, out)


def msm_stage_split(dev, prover, witness, reps=3):
    """The 2^20 prove's G1 MSM of A and G2 MSM of B2 by stage (the last of
    `reps` runs), each output equal to `msm`'s."""
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops import msm as M
    w_std = lb.words_to_planes(witness, dev)
    split = {}
    for group, (table, inf) in (("g1", prover.points_a),
                                ("g2", prover.points_b2)):
        for _ in range(reps):
            ms, out = _staged(M.msm_stages(group, table, inf, w_std,
                                           prover.c_vars))
        check(torch.equal(out, M.msm(group, table, inf, w_std, prover.c_vars)),
              f"the {group} MSM by stage differs from msm")
        split[group] = ms
        print(f"  {group} MSM 2^{LOG_N} by stage (ms, c = {prover.c_vars}): "
              f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}; sum "
              f"{sum(ms.values()):.3f}", flush=True)
    return split


def msm_windows(prover):
    """(G1 c's, G2 c's, fixed-base) of the MSMs of one prove."""
    if prover.fixed:
        f = prover.fixed
        return [f[k][2] for k in ("a", "b1", "c", "h")], [f["b2"][2]], True
    g1 = [prover.c_vars] * 3 + [prover.c_h]
    if hasattr(prover, "c_round"):       # UltraGroth: round commitment, final C
        g1 = [prover.c_round, prover.c_vars, prover.c_vars, prover.c_final,
              prover.c_h]
    return g1, [prover.c_vars], False


def expected_launches(windows):
    """{kernel: launches} of the reduction and combine kernels for one
    path's MSMs (a fixed-base MSM: one reduction over its merged row of
    2^(c-1) buckets in FIXED_SPLIT sub-lanes each, no combine)."""
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops.msm import FIXED_SPLIT
    out = {}
    lanes = FIXED_SPLIT if windows[2] else 1
    for g, cs in (("g1", windows[0]), ("g2", windows[1])):
        out[f"{g}_bucket_reduce"] = sum(
            K.bucket_reduce_launches(lanes << (c - 1)) for c in cs)
        out[f"{g}_window_combine"] = 0 if windows[2] else len(cs)
    return out


@contextlib.contextmanager
def plain_fr_kernels():
    """Route the NTT / quotient through the plain versions of the Fr
    kernels (for the comparison on the card only)."""
    from ultragroth_tpu_torch.ops import kernels as K
    saved = K.fr_mont_mul, K.fr_butterfly, K.fr_cg_ntt
    K.fr_mont_mul, K.fr_butterfly, K.fr_cg_ntt = (
        K.fr_mont_mul_plain, K.fr_butterfly_plain, K.fr_cg_ntt_plain)
    try:
        yield
    finally:
        K.fr_mont_mul, K.fr_butterfly, K.fr_cg_ntt = saved


def ultragroth_small(dev, r1cs, host_setup):
    """Device set-ups on the card, byte for byte against the host set-ups;
    a small UltraGroth proof on the card against the CPU, verified, and
    refused after a tampered public input or round commitment."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.io.wtns import parse_wtns
    from ultragroth_tpu_torch.io.zkey import parse_ultragroth_zkey
    from ultragroth_tpu_torch.oracle import curve as oc
    from ultragroth_tpu_torch.protocol import ultragroth as ug
    from ultragroth_tpu_torch.protocol.prover import TorchUltraGrothProver
    from ultragroth_tpu_torch.testkit.circuits import LookupCircuit
    from ultragroth_tpu_torch.testkit.dsetup import (groth16_setup_fast,
                                                     ultragroth_setup_fast)
    from ultragroth_tpu_torch.testkit.setup import ultragroth_setup

    def same(a, b):
        return (a.zkey_bytes == b.zkey_bytes and a.vk_json == b.vk_json
                and a.taus == b.taus)

    fast = groth16_setup_fast(r1cs, seed=7)
    check(same(fast, host_setup), "groth16_setup_fast on the card differs "
          "from the host set-up")
    print(f"  groth16_setup_fast 2^10 == host set-up; seconds "
          f"{json.dumps(fast.seconds)}", flush=True)
    chunks, table = UG_SMALL
    circ = LookupCircuit(np.random.default_rng(17).integers(0, table,
                                                            size=chunks), table)
    args = (circ.r1cs, circ.round_indexes, circ.final_indexes, circ.rand_indx)
    host = ultragroth_setup(*args, seed=9)
    fast = ultragroth_setup_fast(*args, seed=9)
    check(same(fast, host), "ultragroth_setup_fast on the card differs from "
          "the host set-up")
    print(f"  ultragroth_setup_fast ({chunks} chunks, T = {table}) == host "
          "set-up", flush=True)

    zk = parse_ultragroth_zkey(np.frombuffer(host.zkey_bytes, np.uint8))
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    pins = dict(r0=R0_BLIND, r=R_BLIND, s=S_BLIND)
    proof, w_final = TorchUltraGrothProver(zk).prove(wt.values, wt, **pins)
    cpu_proof, cpu_w = TorchUltraGrothProver(zk, device="cpu").prove(
        wt.values, wt, **pins)
    check(proof.to_json() == cpu_proof.to_json() and w_final == cpu_w,
          "the card's UltraGroth proof differs from the port's CPU proof")
    vk = ug.UltraGrothVerificationKey.from_json_dict(host.vk_json)
    pub = ug.public_signals(w_final, zk.n_public, zk.rand_indx)
    check(ug.verify(proof, pub, vk), "small UltraGroth proof does not verify")
    check(not ug.verify(proof, [(pub[0] + 1) % R], vk),
          "tampered public input verifies")
    bad = ug.UltraGrothProof(proof.pi_a, proof.pi_b, proof.pi_f,
                             oc.g1_add(proof.pi_r, oc.G1))
    check(not ug.verify(bad, pub, vk), "tampered round commitment verifies")


def ultragroth_full_width(dev, drive):
    """The lookup circuit at domain 2^20: key from the device set-up on the
    card, the first prove, the 5-pairing check, the challenge and the
    lookup signals against the oracle, the steady prove."""
    from ultragroth_tpu_torch.io.fieldenc import array_to_ints
    from ultragroth_tpu_torch.io.wtns import parse_wtns
    from ultragroth_tpu_torch.io.zkey import parse_ultragroth_zkey
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.protocol import ultragroth as ug
    from ultragroth_tpu_torch.protocol.prover import TorchUltraGrothProver
    from ultragroth_tpu_torch.testkit.circuits import LookupCircuit
    from ultragroth_tpu_torch.testkit.dsetup import ultragroth_setup_fast

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    circ = LookupCircuit(rng.integers(0, UG_TABLE, size=UG_CHUNKS), UG_TABLE)
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    rows = len(circ.r1cs.rows)
    print(f"  circuit: {UG_CHUNKS} chunks, T = {UG_TABLE}, {rows} constraints, "
          f"n_vars {circ.r1cs.n_vars}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    check((1 << LOG_N) // 2 < rows <= 1 << LOG_N, f"domain is not 2^{LOG_N}")

    t0 = time.perf_counter()
    st = drive("ultragroth_setup_2^20", lambda: ultragroth_setup_fast(
        circ.r1cs, circ.round_indexes, circ.final_indexes, circ.rand_indx,
        seed=9))
    print(f"  device set-up {time.perf_counter() - t0:.2f} s, by part "
          f"{json.dumps(st.seconds)}; zkey {len(st.zkey_bytes)} bytes",
          flush=True)

    def prove_first():
        t0 = time.perf_counter()
        zk = parse_ultragroth_zkey(np.frombuffer(st.zkey_bytes, np.uint8))
        prover = TorchUltraGrothProver(zk)
        torch.cuda.synchronize()
        print(f"  parse + prover set-up {time.perf_counter() - t0:.2f} s; "
              f"MSM sizes: round {len(zk.round_indexes)} (c = "
              f"{prover.c_round}), final C {len(zk.final_indexes)} (c = "
              f"{prover.c_final}), A/B1/B2 {zk.n_vars} (c = {prover.c_vars}),"
              f" H {zk.domain_size} (c = {prover.c_h})", flush=True)
        t0 = time.perf_counter()
        proof, w_final = prover.prove(wt.values, wt)
        torch.cuda.synchronize()
        print(f"  first prove {time.perf_counter() - t0:.3f} s "
              f"last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)
        return zk, prover, proof, w_final

    zk, prover, proof, w_final = drive("ultragroth_2^20", prove_first)
    PATH_WINDOWS["ultragroth_2^20"] = msm_windows(prover)
    # the set-up's fixed-base runs: one a non-empty section (G1: IC, the
    # random signal's IC, A, B1, round C, final C, H; G2: B2)
    g1_runs = sum(1 for n in (len(zk.ic), 1, zk.n_vars, zk.n_vars,
                              len(zk.round_indexes), len(zk.final_indexes),
                              zk.domain_size) if n)
    FB_RUNS["ultragroth_setup_2^20"] = (g1_runs, 1)

    t0 = time.perf_counter()
    vk = ug.UltraGrothVerificationKey.from_json_dict(st.vk_json)
    pub = ug.public_signals(w_final, zk.n_public, zk.rand_indx)
    check(ug.verify(proof, pub, vk), "the 2^20 UltraGroth proof does not verify")
    check(not ug.verify(proof, [(pub[0] + 1) % R], vk),
          "a tampered public input verifies at 2^20")
    rand = ug.derive_challenge(proof.pi_r)
    check(rand == w_final[zk.rand_indx],
          "the challenge signal is not Keccak(pi_r) mod r")
    print(f"  5-pairing verify: accepts, refuses a tampered public input; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    w0 = array_to_ints(wt.values)
    ug.compute_lookup(w0, wt.chunks, wt.frequencies, wt.wtns_indxs,
                      wt.push_indxs, rand)
    check(w0 == w_final, "the final witness differs from the oracle's "
          "compute_lookup")
    print(f"  lookup signals == oracle compute_lookup ({len(wt.push_indxs)} "
          f"pushed); {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    drive("ultragroth_2^20_steady", lambda: prover.prove(wt.values, wt))
    PATH_WINDOWS["ultragroth_2^20_steady"] = msm_windows(prover)
    print(f"  steady prove {time.perf_counter() - t0:.3f} s "
          f"last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)
    return st, circ, wt, prover


# ---------------------------------------------------------------------------
# the MMA field, fixed-base tables, the entry points
# ---------------------------------------------------------------------------

def mma_field_checks(dev, mma_ms):
    """mont_mul_mma directly, at 2^16 + 37 lanes (a ragged last warp, its
    lanes clamped), through the MMA build's
    fr_mont_mul and the Fq product probe, with the edges 0, 1, p - 1,
    inputs in [p, 2p) and a < 2^256 (b < p): equal to the plain CIOS
    product, to mont_mul_mma_plain and to the CIOS build.  Returns the
    `mont_mul_mma` row's numbers: the MMA fr_mont_mul at 2^20 lanes
    (`mma_ms`, timed by the mma pass of phase 2) beside its bound and
    mont_mul_mma_plain at 2^20 on the card."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops.field import fq, fr
    from ultragroth_tpu_torch.ops.mxufield import mont_mul_mma_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    n = (1 << 16) + 37
    worst = 0
    for F, kern, p in ((fr(), K.fr_mont_mul, R), (fq(), K.fq_mont_mul, Q)):
        a = _rand_field((8, n), p, gen, dev)
        b = _rand_field((8, n), p, gen, dev)
        top = (1 << 256) - 1
        edges = [(0, None), (1, None), (p - 1, None), (None, 0), (None, 1),
                 (None, p - 1), (p, p), (2 * p - 1, 2 * p - 1),
                 (p + 12345, 2 * p - 7), (top, p - 1), (top, None),
                 (top - 12345, None)]
        for i, (x, y) in enumerate(edges):
            if x is not None:
                a[:, i] = lb.ints_to_planes([x], dev)[:, 0]
            if y is not None:
                b[:, i] = lb.ints_to_planes([y], dev)[:, 0]
        with K.field_mode("mma"):
            k = kern(a, b)
        with K.field_mode("cios"):
            k_cios = kern(a, b)
        want = F.mont_mul(a, b)
        worst = max(worst, int((lb.widen(k) - lb.widen(want)).abs().max()))
        check(torch.equal(k, want) and torch.equal(k, k_cios)
              and torch.equal(k, mont_mul_mma_plain(F, a, b)),
              f"mont_mul_mma ({F.name}) disagrees with the plain products")
        print(f"  mont_mul_mma {F.name}: {n} lanes with {len(edges)} edge "
              "lanes == plain CIOS == mont_mul_mma_plain == the CIOS build",
              flush=True)
    n = 1 << LOG_N
    a = _rand_field((8, n), R, gen, dev)
    b = _rand_field((8, n), R, gen, dev)
    plain_ms = host_time_ms(lambda: mont_mul_mma_plain(fr(), a, b))
    b_bytes = 3 * 32 * n / HBM_BYTES_PER_S * 1e3
    b_ops = max(n * MMA_IMAD / IMAD_PER_S, n * MMA_U8_OPS / INT8_OPS_PER_S) * 1e3
    row = dict(max_abs_err=worst, ms=mma_ms, plain_ms=plain_ms,
               bound_ms=max(b_bytes, b_ops),
               bound_by="bytes" if b_bytes >= b_ops else "operations",
               library_ms=None)
    print(f"  mont_mul_mma (MMA fr_mont_mul, 2^{LOG_N} lanes): {mma_ms:.4f} ms "
          f"plain {plain_ms:.2f} ms bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: bytes {b_bytes:.4f}, int32 "
          f"{n * MMA_IMAD / IMAD_PER_S * 1e3:.4f}, int8 tensor "
          f"{n * MMA_U8_OPS / INT8_OPS_PER_S * 1e3:.4f})", flush=True)
    return row


def _row_point(group, row):
    """A point-major table row (Montgomery words) -> oracle affine (None
    at (0, 0), the table's infinity)."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    rinv = pow(1 << 256, -1, Q)
    w = row.reshape(-1, 8).cpu().numpy().astype(np.uint32)
    v = [int.from_bytes(r.tobytes(), "little") * rinv % Q for r in w]
    if not any(v):
        return None
    return (v[0], v[1]) if group == "g1" else ((v[0], v[1]), (v[2], v[3]))


def fixed_tables_check(prover, specs, samples=6):
    """Sampled rows of each 2^20 table against the synthetic key's known
    logs: row w * Npad + i == k_i * 2^(c*w) * G."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.oracle import curve as oc
    rng = random.Random(SEED)
    for name, (table, inf, c) in prover.fixed.items():
        spec = specs[name]
        group, npad = spec[0], inf.shape[0]
        mul, gen = ((oc.g1_mul, oc.G1) if group == "g1"
                    else (oc.g2_mul, oc.G2))
        nw = table.shape[0] // npad
        for _ in range(samples):
            w, i = rng.randrange(1, nw), rng.randrange(spec[4])
            want = mul(gen, known_log(spec, i) * pow(2, c * w, R) % R)
            check(_row_point(group, table[w * npad + i]) == want,
                  f"fixed-base table {name}: row {w} x {npad} + {i} is not "
                  "its known-log value")
    print(f"  fixed-base tables: {samples} sampled rows of each of "
          f"{sorted(prover.fixed)} equal k_i * 2^(c*w) * G", flush=True)


def fixed_msm_stage_split(dev, prover, witness, expect, reps=3):
    """The fixed-base MSMs of A (G1) and B2 (G2) over their 2^20 tables by
    stage (`msm_fixed_stages`, the last of `reps` runs), each output equal
    to `msm_fixed`'s and to its known-log value."""
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops import msm as M
    from ultragroth_tpu_torch.protocol.prover import normalize_outputs
    w_std = lb.words_to_planes(witness, dev)
    split, outs = {}, {}
    for group, key in (("g1", "a"), ("g2", "b2")):
        table, inf, c = prover.fixed[key]
        for _ in range(reps):
            ms, out = _staged(M.msm_fixed_stages(group, table, inf, w_std, c))
        check(torch.equal(out, M.msm_fixed(group, table, inf, w_std, c)),
              f"the fixed-base {group} MSM by stage differs from msm_fixed")
        split[f"{group}_fixed"], outs[group] = ms, out
        print(f"  fixed-base {group} MSM 2^{LOG_N} by stage (ms, c = {c}, "
              f"{M.FIXED_SPLIT} sub-lanes a bucket): "
              f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}; sum "
              f"{sum(ms.values()):.3f}", flush=True)
    g1, g2 = normalize_outputs((outs["g1"],) * 4, outs["g2"])
    check(g1[0] == expect["a"] and g2 == expect["b2"], "a fixed-base MSM "
          "by stage differs from its known-log value")
    return split


def fixed_base_prove(dev, drive, zk, witness, expect, proof_json, specs):
    """The 2^20 Groth16 key of phase 4 with a table for each of its five
    point sets (the build a driven path: `fixed_tables_2^20`): sampled
    table rows against their known-log values, the five MSM outputs
    against theirs and the proof against the variable-base proof for the
    same r, s; then the G1 and G2 fixed-base MSMs by stage, returned."""
    from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                     normalize_outputs)
    from ultragroth_tpu_torch.trace import Tracer
    os.environ["ULTRAGROTH_FIXED_MSM_MB"] = FIXED_MSM_MB
    try:
        t0 = time.perf_counter()
        prover = drive("fixed_tables_2^20", lambda: TorchGroth16Prover(zk))
    finally:
        del os.environ["ULTRAGROTH_FIXED_MSM_MB"]
    check(sorted(prover.fixed) == ["a", "b1", "b2", "c", "h"],
          f"fixed-base tables for {sorted(prover.fixed)} only")
    table_bytes = sum(t.numel() * t.element_size()
                      for t, _, _ in prover.fixed.values())
    by_set = prover.fixed_seconds_by_set
    by_group = {g: sum(v for k, v in by_set.items() if specs[k][0] == g)
                for g in ("g1", "g2")}
    print(f"  fixed-base tables built in {prover.fixed_seconds:.2f} s "
          f"(prover set-up {time.perf_counter() - t0:.2f} s): "
          f"{json.dumps({k: v[2] for k, v in prover.fixed.items()})} "
          f"(c per set), {table_bytes / 1e9:.3f} GB; seconds by set "
          f"{json.dumps({k: round(v, 4) for k, v in by_set.items()})}, by "
          f"group {json.dumps({k: round(v, 4) for k, v in by_group.items()})}",
          flush=True)
    fixed_tables_check(prover, specs)
    t0 = time.perf_counter()
    proof = drive("groth16_2^20_fixed", lambda: prover.prove(
        witness, r=R_BLIND, s=S_BLIND))
    PATH_WINDOWS["groth16_2^20_fixed"] = msm_windows(prover)
    print(f"  first prove {time.perf_counter() - t0:.3f} s last_phase_ms "
          f"{json.dumps(prover.last_phase_ms)}", flush=True)
    check(proof.to_json() == proof_json,
          "the fixed-base proof differs from the variable-base proof")
    outs = prover.msm_outputs(witness, Tracer(dev))
    (pa, pb1, pc, ph), pb2 = normalize_outputs(
        (outs[0], outs[1], outs[3], outs[4]), outs[2])
    got = {"a": pa, "b1": pb1, "b2": pb2, "c": pc, "h": ph}
    for name in expect:
        check(got[name] == expect[name], f"fixed-base 2^{LOG_N} MSM {name} "
              "differs from its known-log value")
    print("  five fixed-base MSM outputs equal their known-log values; "
          "proof == the variable-base proof", flush=True)
    t0 = time.perf_counter()
    prover.prove(witness, r=R_BLIND, s=S_BLIND)
    torch.cuda.synchronize()
    print(f"  steady prove {time.perf_counter() - t0:.3f} s last_phase_ms "
          f"{json.dumps(prover.last_phase_ms)}", flush=True)
    return fixed_msm_stage_split(dev, prover, witness, expect)


def api_mma_prove(drive, mma_paths, st, uwtns, wt, default_prover):
    """`api.UltraGrothProver` on the 2^20 key in the mma mode: its proof
    equal to the default mode's for pinned randomness, accepted by
    `api.ultra_groth_verify`, a tampered public input refused."""
    from ultragroth_tpu_torch import api
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops import kernels as K
    pins = dict(r0=R0_BLIND, r=R_BLIND, s=S_BLIND)
    os.environ["ULTRAGROTH_MXU_FIELD"] = "1"
    try:
        t0 = time.perf_counter()
        handle = api.UltraGrothProver(st.zkey_bytes)
        torch.cuda.synchronize()
    finally:
        del os.environ["ULTRAGROTH_MXU_FIELD"]
    check(handle._prover.field_mode == "mma", "the API prover is not in "
          "the mma mode")
    print(f"  api.UltraGrothProver (mma) set-up {time.perf_counter() - t0:.2f}"
          " s", flush=True)
    t0 = time.perf_counter()
    proof_json, public_json = drive("ultragroth_2^20_api_mma",
                                    lambda: handle.prove(uwtns, **pins))
    mma_paths["ultragroth_2^20_api_mma"] = K.launch_counts("mma")
    PATH_WINDOWS["ultragroth_2^20_api_mma"] = msm_windows(handle._prover)
    print(f"  first prove (mma) {time.perf_counter() - t0:.3f} s "
          f"last_phase_ms {json.dumps(handle._prover.last_phase_ms)}",
          flush=True)
    t0 = time.perf_counter()
    handle.prove(uwtns, **pins)
    print(f"  steady prove (mma) {time.perf_counter() - t0:.3f} s "
          f"last_phase_ms {json.dumps(handle._prover.last_phase_ms)}",
          flush=True)
    t0 = time.perf_counter()
    proof, _ = default_prover.prove(wt.values, wt, **pins)
    torch.cuda.synchronize()
    print(f"  steady prove (cios, the default) {time.perf_counter() - t0:.3f}"
          f" s last_phase_ms {json.dumps(default_prover.last_phase_ms)}",
          flush=True)
    check(proof_json == proof.to_json(),
          "the mma-mode proof differs from the default mode's")
    vk_json = json.dumps(st.vk_json)
    check(api.ultra_groth_verify(proof_json, public_json, vk_json)
          == api.VERIFIER_VALID_PROOF, "api.ultra_groth_verify refuses the "
          "mma-mode proof")
    pub = json.loads(public_json)
    bad = json.dumps([str((int(pub[0]) + 1) % R)] + pub[1:])
    check(api.ultra_groth_verify(proof_json, bad, vk_json)
          == api.VERIFIER_INVALID_PROOF, "a tampered public input verifies")
    print("  mma proof == default-mode proof; api.ultra_groth_verify: "
          "valid, a tampered public input invalid", flush=True)


def _http(base, path, data=None, octet=False):
    headers = {"Content-Type": "application/octet-stream"} if octet else {}
    req = urllib.request.Request(f"{base}{path}", data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read() or b"null")


def _wait_status(base, done, seconds):
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        st = _http(base, "/status")
        if done(st["status"]):
            return st
        time.sleep(0.05)
    raise CheckFailed(f"server status stuck at {st['status']}")


def server_check(st, uwtns):
    """`server.serve` in this process on the 2^20 UltraGroth key (written
    to a temporary directory): a POSTed .uwtns gives a verifying proof; a
    second POST cancelled mid-prove ends `aborted` within a phase."""
    from ultragroth_tpu_torch import api
    from ultragroth_tpu_torch.server import serve
    tmp = tempfile.mkdtemp(prefix="ultragroth_smoke_")
    try:
        path = os.path.join(tmp, "lookup.zkey")
        with open(path, "wb") as f:
            f.write(st.zkey_bytes)
        t0 = time.perf_counter()
        fp, httpd = serve([path], port=0)
        check(type(fp.provers["lookup"]).__name__ == "UltraGrothProver",
              "the server did not detect the UltraGroth key")
        print(f"  server up, key loaded in {time.perf_counter() - t0:.2f} s",
              flush=True)
        worker = threading.Thread(target=httpd.serve_forever, daemon=True)
        worker.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            t0 = time.perf_counter()
            _http(base, "/input/lookup", uwtns, octet=True)
            res = _wait_status(base, lambda s: s not in ("busy", "ready"), 600)
            check(res["status"] == "success", f"server status {res}")
            phases = fp.provers["lookup"]._prover.last_phase_ms
            print(f"  POST -> success in {time.perf_counter() - t0:.2f} s; "
                  f"last_phase_ms {json.dumps(phases)}", flush=True)
            check(api.ultra_groth_verify(res["proof"], res["pubData"],
                                         json.dumps(st.vk_json))
                  == api.VERIFIER_VALID_PROOF,
                  "the server's proof does not verify")
            _http(base, "/input/lookup", uwtns, octet=True)
            _wait_status(base, lambda s: s == "busy", 60)
            time.sleep(1.0)
            t0 = time.perf_counter()
            _http(base, "/cancel", b"")
            res = _wait_status(base, lambda s: s != "busy", 600)
            abort_ms = (time.perf_counter() - t0) * 1e3
            longest = max(phases.values())
            check(res["status"] == "aborted" and fp.proof is None,
                  f"/cancel mid-prove gave {res['status']}")
            check(abort_ms <= 2 * longest + 2000, f"aborted {abort_ms:.0f} ms "
                  f"after /cancel; the longest phase took {longest:.0f} ms")
            print(f"  /cancel mid-prove -> aborted after {abort_ms:.0f} ms "
                  f"(longest phase {longest:.0f} ms)", flush=True)
        finally:
            httpd.shutdown()
            httpd.server_close()
            worker.join(timeout=60)
            fp.provers.clear()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_check():
    """The CLI on the card at 2^10, each command in a subprocess: setup,
    prove, verify (exit 0), verify of a tampered public file (exit 1)."""
    tmp = tempfile.mkdtemp(prefix="ultragroth_cli_")
    env = {k: v for k, v in os.environ.items()
           if k not in ("ULTRAGROTH_MXU_FIELD", "ULTRAGROTH_FIXED_MSM_MB")}
    root = os.path.dirname(os.path.abspath(__file__))

    def run(*args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "ultragroth_tpu_torch.cli",
                              *args], cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        print(f"  cli {args[0]}: exit {res.returncode} in "
              f"{time.perf_counter() - t0:.2f} s "
              f"{res.stderr.strip().splitlines()[-1:] or ''}", flush=True)
        return res.returncode

    try:
        f = {k: os.path.join(tmp, k) for k in
             ("c.zkey", "vk.json", "w.wtns", "proof.json", "pub.json",
              "bad.json")}
        check(run("setup", f["c.zkey"], "--vk", f["vk.json"], "--wtns",
                  f["w.wtns"], "--constraints", str(SMALL_CONSTRAINTS),
                  "--seed", "3") == 0, "cli setup failed")
        check(run("prove", f["c.zkey"], f["w.wtns"], f["proof.json"],
                  f["pub.json"]) == 0, "cli prove failed")
        check(run("verify", f["vk.json"], f["pub.json"], f["proof.json"]) == 0,
              "cli verify refuses the CLI's proof")
        with open(f["pub.json"]) as fh:
            pub = json.load(fh)
        with open(f["bad.json"], "w") as fh:
            json.dump([str(int(pub[0]) + 1)] + pub[1:], fh)
        check(run("verify", f["vk.json"], f["bad.json"], f["proof.json"]) != 0,
              "cli verify accepts a tampered public input")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the multi-device layer, the C ABI and the native host runtime
# ---------------------------------------------------------------------------

def mesh_prove(dev, drive, zk, witness, expect, proof_json):
    """Phase 4c: the 2^20 key of phase 4 over Mesh([cuda:0] * MESH) (the
    'chip' axis on one card; the path `groth16_2^20_mesh`): each shard's
    MSMs, the cross-shard folds (`curve_add_where`) and the 4-step
    quotient; the proof against phase 4's for the same r, s and the five
    sharded MSM outputs against their known logs."""
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.parallel import Mesh
    from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                     normalize_outputs)
    from ultragroth_tpu_torch.trace import Tracer
    t0 = time.perf_counter()
    prover = TorchGroth16Prover(zk, mesh=Mesh([dev] * MESH))
    torch.cuda.synchronize()
    print(f"  mesh prover ({MESH} shards on one card) set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(not prover.fixed, "fixed-base tables under a mesh")
    t0 = time.perf_counter()
    proof = drive("groth16_2^20_mesh", lambda: prover.prove(
        witness, r=R_BLIND, s=S_BLIND))
    PATH_WINDOWS["groth16_2^20_mesh"] = msm_windows(prover)
    print(f"  first prove {time.perf_counter() - t0:.3f} s last_phase_ms "
          f"{json.dumps(prover.last_phase_ms)}", flush=True)
    check(proof.to_json() == proof_json,
          "the mesh proof differs from the single-device proof")
    outs = prover.msm_outputs(witness, Tracer(dev))
    (pa, pb1, pc, ph), pb2 = normalize_outputs(
        (outs[0], outs[1], outs[3], outs[4]), outs[2])
    got = {"a": pa, "b1": pb1, "b2": pb2, "c": pc, "h": ph}
    for name in expect:
        check(got[name] == expect[name], f"sharded 2^{LOG_N} MSM {name} "
              "differs from its known-log value")
    print("  five sharded MSM outputs equal their known-log values; proof "
          "== the single-device proof", flush=True)
    # the fold's kernel at the mesh path's shape: MESH / 2 lanes, every
    # lane added (ok None); G1 two distinct points, G2 a doubling
    for group, a, b in (("g1", outs[0], outs[1]), ("g2", outs[2], outs[2])):
        a = torch.stack([a] * (MESH // 2), -1).contiguous()
        b = torch.stack([b] * (MESH // 2), -1).contiguous()
        k = K.curve_add_where(group, a, b)
        pl = K.curve_add_where_plain(group, a, b)
        check(torch.equal(k, pl), f"{group}_add_where at the mesh fold's "
              "shape disagrees with its plain version")
        MESH_FOLD[f"{group}_add_where"] = {
            "lanes": MESH // 2, "max_abs_err": 0,
            "ms": cuda_time_ms(lambda: K.curve_add_where(group, a, b), 50)}
    print(f"  add_where at the fold's shape == plain: "
          f"{json.dumps(MESH_FOLD)}", flush=True)
    t0 = time.perf_counter()
    prover.prove(witness, r=R_BLIND, s=S_BLIND)
    torch.cuda.synchronize()
    print(f"  steady prove {time.perf_counter() - t0:.3f} s last_phase_ms "
          f"{json.dumps(prover.last_phase_ms)}", flush=True)


def sharded_ntt_check(dev, drive):
    """Phase 4d: the 4-step NTT at 2^20 over Mesh([cuda:0] * MESH), forward
    and inverse, in both NTT modes (paths `ntt_sharded_2^20` and
    `ntt_sharded_2^20_base`), equal to `ntt_fast`; timed beside it."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops.ntt import Domain, ntt_fast
    from ultragroth_tpu_torch.parallel import Mesh
    from ultragroth_tpu_torch.parallel.ntt import MeshDomain, ntt_sharded
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = _rand_field((8, 1 << LOG_N), R, gen, dev)
    dom = Domain(LOG_N, dev)
    mdom = MeshDomain(LOG_N, Mesh([dev] * MESH))
    ms = {"ntt_fast": cuda_time_ms(lambda: ntt_fast(a, dom), 5)}
    for mode, path in (("fast", "ntt_sharded_2^20"),
                       ("base", "ntt_sharded_2^20_base")):
        got = drive(path, lambda: [ntt_sharded(a, mdom, inv, mode)
                                   for inv in (False, True)])
        for inv, out in zip((False, True), got):
            check(torch.equal(out, ntt_fast(a, dom, inv)), f"ntt_sharded "
                  f"({mode}, inverse {inv}) differs from ntt_fast")
        ms[f"sharded_{mode}"] = cuda_time_ms(
            lambda: ntt_sharded(a, mdom, False, mode), 5)
    print(f"  ntt_sharded 2^{LOG_N} over {MESH} shards == ntt_fast, forward "
          f"and inverse, both modes; ms {json.dumps(ms)}", flush=True)


def distributed_child():
    """Phase 6e's child process: `runtime.configure` forms a one-rank NCCL
    group (gloo under ULTRAGROTH_PLATFORM=cpu, for a rehearsal) from
    ULTRAGROTH_COORDINATOR; a 2^10 Groth16 prove over its
    ('host', 'chip') mesh against the single-device prove, verified.  The
    key and witness come from the files the parent names."""
    from ultragroth_tpu_torch.runtime import configure, default_device
    configure()
    import torch.distributed as dist
    from ultragroth_tpu_torch.io.fieldenc import array_to_ints
    from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.parallel.mesh import (DATA_AXES,
                                                    make_host_chip_mesh)
    from ultragroth_tpu_torch.protocol import groth16 as g16
    from ultragroth_tpu_torch.protocol.prover import TorchGroth16Prover
    dev = default_device()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.is_initialized() and dist.get_backend() == backend
          and dist.get_world_size() == 1, f"no one-rank {backend} group")
    mesh = make_host_chip_mesh(1)
    check(mesh.group is not None and mesh.shape == {"host": 1, "chip": 1},
          f"mesh {mesh}")
    d = os.environ["UG_SMOKE_DIR"]
    zk = parse_groth16_zkey(np.fromfile(os.path.join(d, "c.zkey"), np.uint8))
    w = np.load(os.path.join(d, "w.npy"))
    with open(os.path.join(d, "vk.json")) as fh:
        vk = g16.VerificationKey.from_json_dict(json.load(fh))
    K.reset_launch_counts()
    proof = TorchGroth16Prover(zk, dev, mesh=mesh, axis=DATA_AXES).prove(
        w, r=R_BLIND, s=S_BLIND)
    launches = {k: v for k, v in K.launch_counts().items() if v}
    single = TorchGroth16Prover(zk, dev).prove(w, r=R_BLIND, s=S_BLIND)
    check(proof.to_json() == single.to_json(),
          "the NCCL mesh proof differs from the single-device proof")
    check(g16.verify(proof, array_to_ints(w[1:zk.n_public + 1]), vk),
          "the NCCL mesh proof does not verify")
    dist.destroy_process_group()
    print(json.dumps({"distributed": "ok", "launches": launches}),
          flush=True)


def distributed_check(setup, w_small):
    """Phase 6e: `distributed_child` in a subprocess with
    ULTRAGROTH_COORDINATOR at a free localhost port, one process."""
    import socket
    tmp = tempfile.mkdtemp(prefix="ultragroth_dist_")
    try:
        with open(os.path.join(tmp, "c.zkey"), "wb") as fh:
            fh.write(setup.zkey_bytes)
        with open(os.path.join(tmp, "vk.json"), "w") as fh:
            json.dump(setup.vk_json, fh)
        np.save(os.path.join(tmp, "w.npy"), w_small)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        env = dict(os.environ, ULTRAGROTH_COORDINATOR=f"127.0.0.1:{port}",
                   ULTRAGROTH_NUM_PROCESSES="1", ULTRAGROTH_PROCESS_ID="0",
                   UG_SMOKE_DIR=tmp)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.distributed_child()"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=600)
        tail = res.stdout.strip().splitlines()[-1:] or [""]
        print(f"  child exit {res.returncode} in "
              f"{time.perf_counter() - t0:.2f} s: {tail[0]}", flush=True)
        check(res.returncode == 0 and tail[0].startswith('{"distributed"'),
              f"distributed child failed: {res.stderr[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def capi_prove(drive, setup, wtns_bytes):
    """Phase 6f: the port's C ABI shim built by g++ (with the remote
    client) and loaded by ctypes into this process; a 2^10 key created,
    proved and destroyed through it on the card (path `capi_2^10`), the
    proof checked by the verifier ABI."""
    import ctypes
    from ultragroth_tpu_torch import capi
    ull = ctypes.c_ulonglong
    t0 = time.perf_counter()
    libs = capi.build_libraries()
    print(f"  shim and remote client built in {time.perf_counter() - t0:.2f}"
          f" s: {libs['capi'].parent.name}", flush=True)
    lib = ctypes.CDLL(str(libs["capi"]))
    zkey = setup.zkey_bytes

    def run():
        obj = ctypes.c_void_p()
        err = ctypes.create_string_buffer(512)
        rc = lib.groth16_prover_create(ctypes.byref(obj), zkey,
                                       ull(len(zkey)), err, ull(512))
        check(rc == 0, f"groth16_prover_create: {rc} {err.value}")
        proof = ctypes.create_string_buffer(8192)
        public = ctypes.create_string_buffer(8192)
        psz, usz = ull(8192), ull(8192)
        rc = lib.groth16_prover_prove(obj, wtns_bytes, ull(len(wtns_bytes)),
                                      proof, ctypes.byref(psz), public,
                                      ctypes.byref(usz), err, ull(512))
        check(rc == 0, f"groth16_prover_prove: {rc} {err.value}")
        lib.groth16_prover_destroy(obj)
        return proof.value, public.value

    t0 = time.perf_counter()
    proof, public = drive("capi_2^10", run)
    err = ctypes.create_string_buffer(512)
    vk = json.dumps(setup.vk_json).encode()
    rc = lib.groth16_verify(proof, public, vk, err, ctypes.c_ulong(512))
    check(rc == 0, f"groth16_verify of the C ABI proof: {rc} {err.value}")
    print(f"  create / prove / destroy through the shim in "
          f"{time.perf_counter() - t0:.2f} s; groth16_verify: valid",
          flush=True)


def native_check(setup):
    """Phase 6g: the native host runtime built by g++: its Keccak against
    the Python one, its repack of 2^20 words against the transpose, its
    section scan against the Python parser's."""
    from ultragroth_tpu_torch import keccak, native
    from ultragroth_tpu_torch.io.binfile import BinFile
    check(native.available(), "the native runtime did not build")
    rng = np.random.default_rng(SEED)
    for n in (0, 64, 135, 136, 137, 1000):
        data = rng.bytes(n)
        check(native.keccak256(data) == keccak.keccak256_py(data),
              f"native Keccak differs at {n} bytes")
    words = rng.integers(0, 1 << 32, size=(1 << LOG_N, 8), dtype=np.uint32)
    t0 = time.perf_counter()
    planes = native.words_to_planes(words)
    t_native = time.perf_counter() - t0
    check(np.array_equal(planes, words.T), "native words_to_planes differs")
    zk = np.frombuffer(setup.zkey_bytes, np.uint8)
    bf = BinFile.parse(zk)
    version, sections = native.binfile_scan(zk)
    want = sorted((t, v.ctypes.data - zk.ctypes.data, v.size)
                  for t, views in bf.sections.items() for v in views)
    check(version == bf.version and sorted(sections) == want,
          "native binfile_scan differs from BinFile.parse")
    print(f"  native Keccak == Python (6 lengths), words_to_planes 2^{LOG_N}"
          f" rows {t_native * 1e3:.1f} ms (host) == transpose, binfile_scan"
          f" == BinFile.parse ({len(sections)} sections)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from ultragroth_tpu_torch.io.fieldenc import array_to_ints
    from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
    from ultragroth_tpu_torch.ops import _build, kernels as K
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops.curve import CurveOps
    from ultragroth_tpu_torch.ops.ntt import (Domain, quotient_scalars,
                                              scatter_coefs)
    from ultragroth_tpu_torch.oracle import curve as oc
    from ultragroth_tpu_torch.protocol import groth16 as g16
    from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                     normalize_outputs)
    from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
    from ultragroth_tpu_torch.testkit.dsetup import groth16_setup_fast
    from ultragroth_tpu_torch.testkit.setup import groth16_setup
    from ultragroth_tpu_torch.trace import Tracer

    paths = {}          # driven path -> its launch counts
    mma_paths = {}      # driven path -> its launches of MMA-built kernels
    card_to_affine = {}  # driven path -> its CurveOps.to_affine calls on the card
    plain_to_affine = CurveOps.to_affine
    affine_calls = [0]

    def counted_to_affine(self, p):
        affine_calls[0] += p.device.type == "cuda"
        return plain_to_affine(self, p)

    CurveOps.to_affine = counted_to_affine

    def drive(name, fn):
        """Run one driven path with the launch counts (and the count of
        plain to-affine calls on the card) set to 0 just before it and
        read just after."""
        K.reset_launch_counts()
        affine_calls[0] = 0
        out = fn()
        torch.cuda.synchronize()
        paths[name] = K.launch_counts()
        card_to_affine[name] = affine_calls[0]
        print(f"  launches [{name}] {json.dumps(paths[name])}", flush=True)
        return out

    with phase("0_device_probe"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        check(len(smi) >= 1, "nvidia-smi gave no card")
        card = smi[0]
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)

    with phase("1_kernel_build"):
        t0 = time.perf_counter()
        outs = _build.build(tuple(_build.MODES))    # all six nvcc together
        for mode in _build.MODES:
            _build.load(mode)
        print(f"  build seconds {time.perf_counter() - t0:.2f}", flush=True)
        for (src, mode), so in outs.items():
            for line in so.with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line or "entry" in line:
                    print(f"  [{mode}] " + line.strip(), flush=True)
        for mode in _build.MODES:
            for g, (regs, local, blocks) in _build.drain_info(mode).items():
                print(f"  [{mode}] {g}_bucket_drain: {regs} registers, "
                      f"{local} B local memory (stack and spills) a thread, "
                      f"{blocks} blocks of 128 threads per SM", flush=True)
            regs, local, blocks = _build.ntt_info(mode, K.CG_MAX_LOG)
            print(f"  [{mode}] fr_cg_ntt (2^{K.CG_MAX_LOG} points a column): "
                  f"{regs} registers, {local} B local memory (stack and "
                  f"spills) a thread, {blocks} blocks per SM", flush=True)
            for (g, name), (regs, local, blocks) in _build.chain_info(
                    mode).items():
                print(f"  [{mode}] {g}_{name}: {regs} registers, {local} B "
                      f"local memory (stack and spills) a thread, {blocks} "
                      "blocks of 128 threads per SM", flush=True)
            # the reduction's tail at the fixed-base MSM's 13 arrays of 16
            # lanes (its largest), the combine at 20 windows
            for (g, name), (regs, local, blocks) in _build.reduce_info(
                    mode, K.REDUCE_TAIL_WIDTH, 13, 20).items():
                print(f"  [{mode}] {g}_{name}: {regs} registers, {local} B "
                      f"local memory (stack and spills) a thread, {blocks} "
                      "blocks per SM", flush=True)

    with phase("2_kernels_vs_plain"):
        drain_cache = {}
        metrics = kernel_checks(dev, "cios", drain_cache)
        torch.cuda.empty_cache()
        metrics_mma = kernel_checks(dev, "mma", drain_cache)
        del drain_cache
        checked = [k for k in metrics_mma if k != "fq_latency"]
        check(all(metrics_mma[k]["max_abs_err"] == 0 for k in checked),
              "an MMA-built kernel differs from its plain version")
        print(f"  all {len(checked)} kernel instances of the mma build "
              "equal their plain versions", flush=True)
        mma_row = mma_field_checks(dev, metrics_mma["fr_mont_mul"]["ms"])
        torch.cuda.empty_cache()

    with phase("3_small_verifiable_prove"):
        r1cs, w_small = square_chain_circuit(SMALL_CONSTRAINTS, seed=5)
        setup = groth16_setup(r1cs, seed=7)
        zk_small = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
        proof = TorchGroth16Prover(zk_small).prove(w_small, r=R_BLIND, s=S_BLIND)
        vk = g16.VerificationKey.from_json_dict(setup.vk_json)
        pub = array_to_ints(w_small[1:zk_small.n_public + 1])
        check(g16.verify(proof, pub, vk), "small proof does not verify")
        check(not g16.verify(proof, [pub[0] + 1], vk),
              "tampered public input verifies")
        cpu_proof = TorchGroth16Prover(zk_small, device="cpu").prove(
            w_small, r=R_BLIND, s=S_BLIND)
        check(proof.to_json() == cpu_proof.to_json(),
              "card proof differs from the port's CPU proof")

    with phase("4_full_width_prove"):
        t0 = time.perf_counter()
        zk, witness, w_ints, specs = synthetic_zkey(LOG_N, SEED)
        print(f"  synthetic key 2^{LOG_N}: n_vars {zk.n_vars}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        Domain(LOG_N, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prover = TorchGroth16Prover(zk)
        torch.cuda.synchronize()
        print(f"  prover set-up {time.perf_counter() - t1:.2f} s, of which "
              f"NTT domain tables {t1 - t0:.2f} s (c = {prover.c_vars})",
              flush=True)

        check(prover.ntt_mode == "fast", "the card's default NTT mode is "
              f"{prover.ntt_mode}, not fast")
        t0 = time.perf_counter()
        drive("groth16_2^20", lambda: prover.prove(witness))
        PATH_WINDOWS["groth16_2^20"] = msm_windows(prover)
        first_s = time.perf_counter() - t0
        print(f"  first prove {first_s:.3f} s", flush=True)
        print(f"  last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)

        outs = prover.msm_outputs(witness, Tracer(dev))
        (pa, pb1, pc, ph), pb2 = normalize_outputs(
            (outs[0], outs[1], outs[3], outs[4]), outs[2])
        w_c = w_ints[zk.n_public + 1:]
        a, b = scatter_coefs(
            K.fr_mont_mul(lb.words_to_planes(witness, dev), prover._r2),
            prover.coef_val_mont, prover.coef_m, prover.coef_c,
            prover.coef_s, zk.domain_size)
        h = drive("quotient_2^20", lambda: quotient_scalars(
            a, b, prover.domain))                             # fast mode
        h_base = drive("quotient_2^20_base", lambda: quotient_scalars(
            a, b, prover.domain, "base"))
        with plain_fr_kernels():
            h_plain = quotient_scalars(a, b, prover.domain)
        check(torch.equal(h, h_base),
              "the fast quotient differs from the base quotient")
        check(torch.equal(h, h_plain),
              "quotient_scalars on the card differs from its plain version")
        q_ms = {mode: cuda_time_ms(lambda: quotient_scalars(
            a, b, prover.domain, mode), 5) for mode in ("fast", "base")}
        print(f"  quotient ms: fast {q_ms['fast']:.3f} base "
              f"{q_ms['base']:.3f} (h equal in both modes and the plain "
              "versions')", flush=True)
        h_ints = lb.planes_to_ints(h)
        expect = {
            "a": oc.g1_mul(oc.G1, known_log_sum(w_ints, specs["a"])),
            "b1": oc.g1_mul(oc.G1, known_log_sum(w_ints, specs["b1"])),
            "b2": oc.g2_mul(oc.G2, known_log_sum(w_ints, specs["b2"])),
            "c": oc.g1_mul(oc.G1, known_log_sum(w_c, specs["c"])),
            "h": oc.g1_mul(oc.G1, known_log_sum(h_ints, specs["h"])),
        }
        got = {"a": pa, "b1": pb1, "b2": pb2, "c": pc, "h": ph}
        for name in expect:
            check(got[name] == expect[name],
                  f"2^{LOG_N} MSM {name} differs from its known-log value")
        print("  five MSM outputs equal their known-log values", flush=True)

        t0 = time.perf_counter()
        proof_fast = prover.prove(witness, r=R_BLIND, s=S_BLIND)
        proof_pinned = proof_fast.to_json()
        torch.cuda.synchronize()
        print(f"  steady prove {time.perf_counter() - t0:.3f} s "
              f"last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)
        msm_split = msm_stage_split(dev, prover, witness)
        base_prover = TorchGroth16Prover(zk, ntt_mode="base")
        proof_base = drive("groth16_2^20_base", lambda: base_prover.prove(
            witness, r=R_BLIND, s=S_BLIND))
        PATH_WINDOWS["groth16_2^20_base"] = msm_windows(base_prover)
        print(f"  base-mode prove last_phase_ms "
              f"{json.dumps(base_prover.last_phase_ms)}", flush=True)
        check(proof_base.to_json() == proof_fast.to_json(),
              "the base-mode proof differs from the fast-mode proof")
        del prover, base_prover, a, b, h, h_base, h_plain, outs
        torch.cuda.empty_cache()

    with phase("4b_fixed_base_prove"):
        msm_split.update(fixed_base_prove(dev, drive, zk, witness, expect,
                                          proof_pinned, specs))
        torch.cuda.empty_cache()

    with phase("4c_mesh_prove"):
        mesh_prove(dev, drive, zk, witness, expect, proof_pinned)
        del zk, witness
        torch.cuda.empty_cache()

    with phase("4d_sharded_ntt"):
        sharded_ntt_check(dev, drive)
        torch.cuda.empty_cache()

    with phase("5_ultragroth_small"):
        ultragroth_small(dev, r1cs, setup)

    with phase("6_ultragroth_full_width"):
        ug_setup, ug_circ, ug_wt, ug_prover = ultragroth_full_width(dev, drive)
        uwtns = ug_circ.uwtns_bytes()
        del ug_circ

    with phase("6b_api_mma_prove"):
        api_mma_prove(drive, mma_paths, ug_setup, uwtns, ug_wt, ug_prover)
        del ug_prover
        torch.cuda.empty_cache()

    with phase("6c_server"):
        server_check(ug_setup, uwtns)
        del ug_setup, ug_wt, uwtns
        torch.cuda.empty_cache()

    with phase("6d_cli"):
        cli_check()

    with phase("6e_distributed"):
        distributed_check(setup, w_small)

    with phase("6f_capi"):
        from ultragroth_tpu_torch import constants as C
        from ultragroth_tpu_torch.constants import FR_MODULUS as R
        from ultragroth_tpu_torch.io.binfile import pack_binfile
        sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
                + r1cs.n_vars.to_bytes(4, "little"))
        capi_prove(drive, setup, pack_binfile(
            C.WTNS_MAGIC, 2, [(1, sec1), (2, w_small.tobytes())]))

    with phase("6g_native"):
        native_check(setup)

    with phase("7_kernel_launches"):
        total = {k: sum(p[k] for p in paths.values()) for k in K.KERNELS}
        # curve_add_where: launched by the mesh path's cross-shard folds
        # only (log2(MESH) a MSM); no single-device path folds anything
        folds = ("g1_add_where", "g2_add_where")
        var_only = ("g1_window_combine", "g2_window_combine")
        ladders = ("g1_fixed_base_mul", "g2_fixed_base_mul")
        tables = ("g1_window_table", "g2_window_table")
        prove_kernels = [k for k in K.KERNELS if k not in (
            "fr_butterfly", *ladders, *tables, *folds)]
        need = {"groth16_2^20": prove_kernels,
                "groth16_2^20_base": ["fr_butterfly"],
                "fixed_tables_2^20": list(tables),
                "groth16_2^20_fixed": [k for k in prove_kernels
                                       if k not in var_only],
                "ultragroth_setup_2^20": ["fr_mont_mul", *ladders],
                "ultragroth_2^20": prove_kernels,
                "ultragroth_2^20_api_mma": prove_kernels,
                "groth16_2^20_mesh": [*prove_kernels, *folds],
                "ntt_sharded_2^20": ["fr_cg_ntt", "fr_mont_mul"],
                "ntt_sharded_2^20_base": ["fr_butterfly", "fr_mont_mul"],
                "capi_2^10": prove_kernels}
        for name, kernels in need.items():
            missing = [k for k in kernels if paths[name][k] == 0]
            check(not missing, f"kernels never launched on {name}: {missing}")
        adds = {p: c[k] for p, c in paths.items() for k in folds
                if c[k] and p not in PATH_SHARDS}
        check(not adds, f"curve_add_where launched on a single-device path: "
              f"{adds}")
        levels = MESH.bit_length() - 1
        got = tuple(paths["groth16_2^20_mesh"][k] for k in folds)
        check(got == (4 * levels, levels), f"groth16_2^20_mesh: (G1, G2) "
              f"add_where launches {got}, not {levels} a MSM")
        print(f"  add_where: (G1, G2) {got} on groth16_2^20_mesh ({levels} "
              f"fold level(s) a MSM), none on the other {len(paths) - 1} "
              "driven paths", flush=True)
        check(not any("horner" in k or "madd_valid" in k for k in K.KERNELS),
              "a Horner or per-step fixed-base kernel is still registered")
        # the per-key chains: one ladder launch a set-up run, one window
        # table launch a point set, and no add_where on the table build
        for name, runs in FB_RUNS.items():
            got = (paths[name]["g1_fixed_base_mul"],
                   paths[name]["g2_fixed_base_mul"])
            check(got == runs, f"{name}: (G1, G2) fixed_base_mul launches "
                  f"{got}, not one a run {runs}")
            print(f"  {name}: (G1, G2) fixed_base_mul launches {got}, one a "
                  "run", flush=True)
        for name, sets in TABLE_SETS.items():
            got = (paths[name]["g1_window_table"],
                   paths[name]["g2_window_table"])
            adds = paths[name]["g1_add_where"] + paths[name]["g2_add_where"]
            check(got == sets and adds == 0, f"{name}: (G1, G2) "
                  f"window_table launches {got} and {adds} add_where, not one "
                  f"a point set {sets} and none")
            print(f"  {name}: (G1, G2) window_table launches {got}, one a "
                  "point set; no add_where", flush=True)
        on_card = {k: v for k, v in card_to_affine.items() if v}
        check(not on_card, f"plain CurveOps.to_affine on the card: {on_card}")
        print(f"  no driven path ran CurveOps.to_affine on the card "
              f"({len(card_to_affine)} paths)", flush=True)
        for name, msms in PATH_MSMS.items():
            drains = (paths[name]["g1_bucket_drain"],
                      paths[name]["g2_bucket_drain"])
            check(drains == msms, f"{name}: (G1, G2) bucket drain launches "
                  f"{drains}, not one per MSM {msms}")
            # the reduction and the combine: the design's launches for the
            # path's MSMs, on each shard
            want = {k: v * PATH_SHARDS.get(name, 1) for k, v in
                    expected_launches(PATH_WINDOWS[name]).items()}
            got = {k: paths[name][k] for k in want}
            check(got == want, f"{name}: reduction launches {got}, the design "
                  f"gives {want}")
            print(f"  {name}: launches {json.dumps(got)} == the design's",
                  flush=True)
        # the fast NTT: two fr_cg_ntt launches a 2^20 transform (the split
        # twiddles and the transpose inside the first), six transforms a
        # quotient, and no fr_mont_mul beyond the base mode's
        q_fast, q_base = paths["quotient_2^20"], paths["quotient_2^20_base"]
        check(q_fast["fr_cg_ntt"] == 12 and q_fast["fr_butterfly"] == 0,
              f"the fast quotient launched {q_fast['fr_cg_ntt']} fr_cg_ntt "
              f"and {q_fast['fr_butterfly']} fr_butterfly, not 12 and 0")
        check(q_fast["fr_mont_mul"] == q_base["fr_mont_mul"],
              f"the fast quotient launched {q_fast['fr_mont_mul']} "
              f"fr_mont_mul, the base one {q_base['fr_mont_mul']}")
        for name in ("groth16_2^20", "groth16_2^20_fixed", "ultragroth_2^20",
                     "ultragroth_2^20_steady", "ultragroth_2^20_api_mma",
                     "groth16_2^20_mesh"):
            want = 12 * PATH_SHARDS.get(name, 1)    # 2^10 rows and columns
            check(paths[name]["fr_cg_ntt"] == want, f"{name}: "
                  f"{paths[name]['fr_cg_ntt']} fr_cg_ntt launches, not {want}")
        print(f"  quotient 2^20: fast {q_fast['fr_cg_ntt']} fr_cg_ntt + "
              f"{q_fast['fr_mont_mul']} fr_mont_mul, base "
              f"{q_base['fr_butterfly']} fr_butterfly + {q_base['fr_mont_mul']}"
              " fr_mont_mul", flush=True)
        api_mma = mma_paths["ultragroth_2^20_api_mma"]
        missing = [k for k in prove_kernels if api_mma[k] == 0]
        check(not missing, f"MMA builds never launched on the mma path: "
              f"{missing}")
        check(sum(api_mma.values()) == sum(
            paths["ultragroth_2^20_api_mma"].values()),
            "the mma path launched kernels of the cios build")
        missing = [k for k, v in total.items() if v == 0]
        check(not missing, f"kernels never launched: {missing}")
        rows = []
        for name, (source, replaces) in K.KERNELS.items():
            row = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": total[name],
                   "launches_by_path": {p: c[name] for p, c in paths.items()}}
            if name.endswith("_bucket_drain"):
                # the same launches' exceptional steps: the complete add
                # of curve_madd_signed, timed apart
                exc = f"{name}:exceptional"
                row["exceptional"] = {
                    "replaces": DRAIN_EXCEPTIONAL_REPLACES, **metrics[exc],
                    "mma_ms": metrics_mma[exc]["ms"]}
            if name == "fr_cg_ntt":
                # the split's first pass of the same launches: the split
                # twiddle product and the transposed store folded in
                row["folded"] = {**metrics["fr_cg_ntt:folded"],
                                 "mma_ms": metrics_mma["fr_cg_ntt:folded"]["ms"]}
            if name.endswith("_bucket_reduce"):
                # the fixed-base MSM's reduction: one window of 2^16
                fx = f"{name}:fixed"
                row["fixed_base"] = {**metrics[fx],
                                     "mma_ms": metrics_mma[fx]["ms"]}
            if name in MESH_FOLD:
                # the same kernel at the shape of the mesh path's folds
                row["mesh_fold"] = MESH_FOLD[name]
            if name.endswith(("_bucket_reduce", "_window_combine")):
                row["mma_latency_floor_ms"] = (
                    metrics_mma[name]["product_depth"]
                    * metrics_mma["fq_latency"]["ms"])
            rows.append({**row, **metrics[name],
                         "mma_ms": metrics_mma[name]["ms"]})
        mma_launches = {p: sum(c.values()) for p, c in mma_paths.items()}
        name, source, replaces = K.MMA_ROW
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(mma_launches.values()),
                     "launches_by_path": mma_launches,
                     "launches_by_kernel": api_mma, **mma_row})

    print(json.dumps({"kernels": rows, "fq_latency_ms": {
        "cios": metrics["fq_latency"]["ms"],
        "mma": metrics_mma["fq_latency"]["ms"]},
        "msm_stage_ms": msm_split}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
