"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (plain nvcc), holds every
kernel against its plain PyTorch version on the card, proves a small
circuit whose proof must verify, then proves a square-chain circuit of
2^20 - 8 constraints (domain 2^20) on a synthetic key whose base points
have known discrete logs, and checks each MSM output exactly.  One line per
phase (name, seconds, pass/fail) is printed as each phase ends; before the
last line come the card's name and power limit and one JSON object with
every kernel's launches on the main path and its times; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import random
import subprocess
import sys
import time

import numpy as np
import torch

LOG_N = 20                 # full width: domain 2^20, the JAX package's e2e size
SMALL_CONSTRAINTS = 1022   # small verifiable prove: n_vars = domain = 2^10
SEED = 20261017
R_BLIND = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
S_BLIND = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores = 33.5e12 FMA/s, and the int32 pipes issue half
# as many multiply-adds: 16.75e12 IMAD/s.  A 32x32 -> 64-bit product is two
# of them (mad.lo, mad.hi).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
MUL_IMAD = 264             # one 8-limb CIOS product: 8 * (16 + 1 + 16)


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
    rng = random.Random(seed)
    vals = [rng.randrange(2, R)]
    for _ in range(n_c):
        vals.append(vals[-1] * vals[-1] % R)
    w = [1, vals[-1]] + vals[:n_c]
    witness = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in w),
                            dtype="<u4").reshape(n_vars, 8).copy()

    sizes = {"a": ("g1", n_vars), "b1": ("g1", n_vars), "b2": ("g2", n_vars),
             "c": ("g1", n_vars - 2), "h": ("g1", domain)}
    specs = {name: (group, rng.randrange(1, R), rng.randrange(1, 1 << 128),
                    rng.randrange(1, 1 << 128), n)
             for name, (group, n) in sizes.items()}
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


def kernel_checks(dev):
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
    horner_n, horner_c = 20, 13

    def err(k, p):
        return int((lb.widen(k) - lb.widen(p)).abs().max())

    def record(name, max_abs, ms, plain_ms, bytes_, imads):
        b_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        b_ops = imads / IMAD_PER_S * 1e3
        results[name] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None)
        print(f"  {name}: err {max_abs} kernel {ms:.4f} ms plain "
              f"{plain_ms:.2f} ms bound {max(b_bytes, b_ops):.4f} ms "
              f"({results[name]['bound_by']})", flush=True)

    # -- Fr kernels -----------------------------------------------------------
    n = table_n
    a = _rand_field((8, n), R, gen, dev)
    b = _rand_field((8, n), R, gen, dev)
    k = K.fr_mont_mul(a, b)
    p = K.fr_mont_mul_plain(a, b)
    check(torch.equal(k, p), "fr_mont_mul disagrees with its plain version")
    record("fr_mont_mul", err(k, p), cuda_time_ms(lambda: K.fr_mont_mul(a, b), 50),
           host_time_ms(lambda: K.fr_mont_mul_plain(a, b)),
           3 * 32 * n, n * MUL_IMAD)
    tw = _rand_field((8, n // 2), R, gen, dev)
    k = K.fr_butterfly(a.clone(), tw)
    p = K.fr_butterfly_plain(a.clone(), tw)
    check(torch.equal(k, p), "fr_butterfly disagrees with its plain version")
    work = a.clone()
    record("fr_butterfly", err(k, p),
           cuda_time_ms(lambda: K.fr_butterfly(work, tw), 50),
           host_time_ms(lambda: K.fr_butterfly_plain(work.clone(), tw)),
           2 * 32 * n + 32 * (n // 2), (n // 2) * MUL_IMAD)

    # -- curve kernels ----------------------------------------------------------
    for group in ("g1", "g2"):
        ops = curve_ops(group)
        kq = 1 if group == "g1" else 2
        e = () if group == "g1" else (2,)
        fq_mul = MUL_IMAD * (1 if group == "g1" else 3)   # Fq2: Karatsuba
        fq_sqr = MUL_IMAD * (1 if group == "g1" else 2)
        table = _rand_field((2, *e, 8, table_n), Q, gen, dev)
        acc = _rand_field((4, *e, 8, lanes), Q, gen, dev)
        ent = torch.randint(0, 2 * table_n, (lanes,), generator=gen,
                            device=dev, dtype=torch.int64)
        cnt = (torch.rand(lanes, generator=gen, device=dev) < 0.9).to(torch.int32)
        # edge lanes: acc at infinity; acc == Q; acc == -Q (acc = Q, sign 1)
        acc[..., :16] = ops.inf_xyzz((16,), dev, torch.int32)
        pid = ent[16:48] >> 1
        q_xyzz = ops.affine_to_xyzz(table[0][..., pid], table[1][..., pid],
                                    torch.zeros(32, dtype=torch.bool, device=dev))
        acc[..., 16:48] = q_xyzz
        ent[16:32] = pid[:16] * 2
        ent[32:48] = pid[16:] * 2 + 1
        cnt[:48] = 1
        orders = ent.to(torch.int32).contiguous()
        gidx = torch.arange(lanes, device=dev, dtype=torch.int32)
        stride = torch.ones(lanes, device=dev, dtype=torch.int32)
        acc = acc.contiguous()
        valid = int(cnt.sum())
        pts_bytes = 2 * kq * 32 * valid            # gathered points
        acc_bytes = 4 * kq * 32 * lanes
        idx_bytes = 4 * 4 * lanes

        k, kf = K.curve_madd_fast(group, acc, table, orders, gidx, stride, cnt, 0)
        p, pf = K.curve_madd_fast_plain(group, acc, table, orders, gidx,
                                        stride, cnt, 0)
        check(torch.equal(k, p) and torch.equal(kf, pf) and bool(pf[16:48].all()),
              f"{group}_madd_fast disagrees with its plain version")
        out = torch.empty_like(acc)
        record(f"{group}_madd_fast", err(k, p),
               cuda_time_ms(lambda: K.curve_madd_fast(
                   group, acc, table, orders, gidx, stride, cnt, 0, out=out), 50),
               host_time_ms(lambda: K.curve_madd_fast_plain(
                   group, acc, table, orders, gidx, stride, cnt, 0)),
               pts_bytes + 2 * acc_bytes + idx_bytes + lanes,
               valid * (8 * fq_mul + 2 * fq_sqr))

        k = K.curve_madd_signed(group, acc, table, orders, gidx, stride, cnt, 0)
        p = K.curve_madd_signed_plain(group, acc, table, orders, gidx, stride,
                                      cnt, 0)
        check(torch.equal(k, p), f"{group}_madd_signed disagrees with its "
              "plain version")
        check(bool(ops.is_inf(p[..., 32:48]).all()), f"{group}: Q + (-Q) != inf")
        record(f"{group}_madd_signed", err(k, p),
               cuda_time_ms(lambda: K.curve_madd_signed(
                   group, acc, table, orders, gidx, stride, cnt, 0, out=out), 50),
               host_time_ms(lambda: K.curve_madd_signed_plain(
                   group, acc, table, orders, gidx, stride, cnt, 0)),
               pts_bytes + 2 * acc_bytes + idx_bytes,
               valid * (8 * fq_mul + 2 * fq_sqr))

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
               host_time_ms(lambda: K.curve_add_where_plain(group, a, b, ok)),
               3 * 4 * kq * 32 * fold_n + fold_n,
               n_ok * (12 * fq_mul + 2 * fq_sqr))

        h = acc[..., :horner_n].contiguous()
        k = K.curve_horner_scale(group, h, horner_c)
        p = K.curve_horner_scale_plain(group, h, horner_c)
        check(torch.equal(k, p), f"{group}_horner_scale disagrees with its "
              "plain version")
        n_dbl = horner_c * horner_n * (horner_n - 1) // 2
        record(f"{group}_horner_scale", err(k, p),
               cuda_time_ms(lambda: K.curve_horner_scale(group, h, horner_c), 10),
               host_time_ms(lambda: K.curve_horner_scale_plain(group, h,
                                                               horner_c)),
               2 * 4 * kq * 32 * horner_n, n_dbl * (6 * fq_mul + 3 * fq_sqr))
    return results


@contextlib.contextmanager
def plain_fr_kernels():
    """Route the NTT / quotient through the plain versions of the Fr
    kernels (for the comparison on the card only)."""
    from ultragroth_tpu_torch.ops import kernels as K
    saved = K.fr_mont_mul, K.fr_butterfly
    K.fr_mont_mul, K.fr_butterfly = K.fr_mont_mul_plain, K.fr_butterfly_plain
    try:
        yield
    finally:
        K.fr_mont_mul, K.fr_butterfly = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from ultragroth_tpu_torch.io.fieldenc import array_to_ints
    from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
    from ultragroth_tpu_torch.ops import _build, kernels as K
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops.ntt import (Domain, quotient_scalars,
                                              scatter_coefs)
    from ultragroth_tpu_torch.oracle import curve as oc
    from ultragroth_tpu_torch.protocol import groth16 as g16
    from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                     normalize_outputs)
    from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
    from ultragroth_tpu_torch.testkit.setup import groth16_setup
    from ultragroth_tpu_torch.trace import Tracer

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
        outs = _build.build()
        _build.load()
        print(f"  build seconds {time.perf_counter() - t0:.2f}", flush=True)
        for so in outs.values():
            for line in so.with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line or "entry" in line:
                    print("  " + line.strip(), flush=True)

    with phase("2_kernels_vs_plain"):
        metrics = kernel_checks(dev)

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

        K.reset_launch_counts()
        t0 = time.perf_counter()
        prover.prove(witness)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        print(f"  first prove {first_s:.3f} s", flush=True)
        print(f"  last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)
        print(f"  launches {json.dumps(launches)}", flush=True)

        outs = prover.msm_outputs(witness, Tracer(dev))
        (pa, pb1, pc, ph), pb2 = normalize_outputs(
            (outs[0], outs[1], outs[3], outs[4]), outs[2])
        w_c = w_ints[zk.n_public + 1:]
        a, b = scatter_coefs(
            K.fr_mont_mul(lb.words_to_planes(witness, dev), prover._r2),
            prover.coef_val_mont, prover.coef_m, prover.coef_c,
            prover.coef_s, zk.domain_size)
        h = quotient_scalars(a, b, prover.domain)
        with plain_fr_kernels():
            h_plain = quotient_scalars(a, b, prover.domain)
        check(torch.equal(h, h_plain),
              "quotient_scalars on the card differs from its plain version")
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
        prover.prove(witness)
        torch.cuda.synchronize()
        print(f"  steady prove {time.perf_counter() - t0:.3f} s "
              f"last_phase_ms {json.dumps(prover.last_phase_ms)}", flush=True)

    with phase("5_kernel_launches"):
        missing = [k for k, v in launches.items() if v == 0]
        check(not missing, f"kernels never launched on the main path: {missing}")
        rows = []
        for name, (source, replaces) in K.KERNELS.items():
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches[name],
                         **metrics[name]})

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
