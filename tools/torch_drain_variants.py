"""Time the design choices of the port's bucket drain apart, on one CUDA card.

    python3 tools/torch_drain_variants.py            # ms a step
    python3 tools/torch_drain_variants.py --prove    # and whole 2^20 proves

Each variant is the cios build of `ultragroth_tpu_torch/csrc/g1_kernels.cu`
or `g2_kernels.cu`, compiled with plain nvcc (one process each, all started
together) from a copy of `csrc/` with the text changes of VARIANTS; the
port builds only `shipped`:

  shipped               the drain as the port builds it: step t+1's point
                        copied by cp.async into a shared-memory slot while
                        step t computes; the Fq products inlined (G1) or
                        one out-of-line call (G2);
  no_prefetch           each point loaded at the step that adds it
                        (DirectFetch);
  out_of_line_product   G1 with the Fq product one out-of-line call;
  inline_product        G2 with every Fq product inlined;
  min_blocks_4          G1 under __launch_bounds__(128, 4): at most 128
                        registers;
  pair                  G2 on two threads a lane, the c0 and c1 halves of
                        every element, operands exchanged by
                        __shfl_xor_sync (PAIR_HEADER, below).

Each variant's drain runs on the inputs of `chip_smoke.py`'s phase 2
(81,920 lanes, a 2^20-point table, 256 steps of random order entries; and
256 steps of +Q / -Q, every step exceptional), its output held equal to the
shipped drain's, and is timed in turns (shipped, variant, variant, shipped)
with CUDA events.  Prints the card, each variant's registers, local (spill)
bytes and blocks per SM, and ms per step.

--prove then makes the Groth16 2^20 key and the UltraGroth 2^20 key as
`chip_smoke.py`'s phases 4 and 6 do and proves each in turns (shipped,
out_of_line_product, out_of_line_product, shipped; several rounds), the
port's G1 drain launcher swapped for the out_of_line_product one's between
proves.  Prints
each prove's seconds and MSM phase times and each variant's mean; the
proofs (pinned randomness) are held equal across the variants.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import torch_variants as V

STEPS = 256
LANES = 20 * 4096
PROVE_ROUNDS = {"groth16": 6, "ultragroth": 3}   # turns of four proves

# The two-thread G2 field of the `pair` variant, included by its
# g2_kernels.cu after launch_common.cuh.  The even thread of a pair holds
# the c0 half of every element, the odd one the c1 half (feh); a product
# exchanges the operands with __shfl_xor_sync: c0 = a0*b0 - a1*b1,
# c1 = a0*b1 + a1*b0, two Fq products (out-of-line calls) a thread.  The
# flags (is_zero) are the pair's, so both threads take every branch
# together.  Each thread copies the whole point and reads its halves.
PAIR_HEADER = r"""
#pragma once
#include "launch_common.cuh"
namespace ug {
struct feh { fe f; };
UG_HD int pair_comp() {
#if defined(__CUDA_ARCH__)
  return threadIdx.x & 1;
#else
  return 0;
#endif
}
UG_HD uint32_t pair_swap(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __shfl_xor_sync(3u << (threadIdx.x & 30), v, 1);
#else
  return v;
#endif
}
struct Fq2Pair {
  using B = FqCall;
  using E = feh;
  UG_HD static fe other(const fe& a) {
    fe r;
#pragma unroll
    for (int l = 0; l < 8; l++) r.v[l] = pair_swap(a.v[l]);
    return r;
  }
  UG_HD static feh zero() { return {B::zero()}; }
  UG_HD static feh one_mont() { return {pair_comp() ? B::zero() : B::one_mont()}; }
  UG_HD static feh add(const feh& a, const feh& b) { return {B::add(a.f, b.f)}; }
  UG_HD static feh sub(const feh& a, const feh& b) { return {B::sub(a.f, b.f)}; }
  UG_HD static feh neg(const feh& a) { return {B::neg(a.f)}; }
  UG_HD static bool is_zero(const feh& a) {
    const uint32_t z = B::is_zero(a.f);
    const uint32_t partner = pair_swap(z);    // both threads reach the swap
    return z && partner;
  }
  UG_HD static feh mul(const feh& a, const feh& b) {
    const int c = pair_comp();
    const fe ao = other(a.f), bo = other(b.f);
    const fe p1 = B::mul(c ? ao : a.f, b.f);
    const fe p2 = B::mul(c ? a.f : ao, bo);
    return {c ? B::add(p1, p2) : B::sub(p1, p2)};
  }
  UG_HD static feh sqr(const feh& a) {     // c0 = (a0+a1)(a0-a1), c1 = 2 a0 a1
    const int c = pair_comp();
    const fe ao = other(a.f);
    const fe m = B::mul(c ? a.f : B::add(a.f, ao), c ? ao : B::sub(a.f, ao));
    return {c ? B::add(m, m) : m};
  }
  UG_HD static feh exit(const feh& a) { return {B::exit(a.f)}; }
};
UG_HD void load_elem(const uint32_t* p, int64_t n, int64_t i, int e, feh& r) {
  r.f = load(p, n, i, 2 * e + pair_comp());
}
UG_HD void store_elem(uint32_t* p, int64_t n, int64_t i, int e, const feh& a) {
  store(p, n, i, 2 * e + pair_comp(), a.f);
}
template <>
struct PointIO<Fq2Pair> {
  static constexpr int kWords = 32;
  static constexpr int kVecs = 8;
};
}  // namespace ug

template <>
struct SlotFetch<ug::Fq2Pair> : SlotFetch<ug::Fq2> {
  using SlotFetch<ug::Fq2>::SlotFetch;
  __host__ __device__ void take(ug::feh& qx, ug::feh& qy) {
#if defined(__CUDA_ARCH__)
    ug_cp_async_wait_all();
    const uint4* s = slot + buf * kVecs * threads;
    const int c = ug::pair_comp();   // vectors 2c, 2c+1 (x), 4+2c, 5+2c (y)
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const uint4 v = s[(2 * c + (k & 1) + 4 * (k >> 1)) * threads];
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int l = 0; l < 8; l++) { qx.f.v[l] = w[l]; qy.f.v[l] = w[8 + l]; }
    if (ent & 1) qy = ug::Fq2Pair::neg(qy);
#else
    (void)qx;
    (void)qy;
#endif
  }
};
"""

# {group: {variant: [(file in csrc/, text, replacement), ...]}}
_LANE = ("  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  UG_LANE_BEGIN(ug::FqParams, i, n);\n  int32_t stop_all")
_NO_PREFETCH = [
    ("curve_kernels.inc", "  SlotFetch<UG_DRAIN_F> f(table, threadIdx.x, blockDim.x);\n",
     "  ug::DirectFetch<UG_DRAIN_F> f{table, 0};\n"),
    ("curve_kernels.inc",
     "#define UG_DRAIN_SLOT_BYTES ug_drain_slot_bytes<UG_DRAIN_F>(UG_THREADS)\n",
     "#define UG_DRAIN_SLOT_BYTES 0\n")]
VARIANTS = {
    "g1": {
        "shipped": [],
        "no_prefetch": _NO_PREFETCH,
        "out_of_line_product": [("g1_kernels.cu", "#define UG_DRAIN_F ug::Fq\n",
                                 "#define UG_DRAIN_F ug::FqCall\n")],
        "min_blocks_4": [("curve_kernels.inc",
                          "__launch_bounds__(UG_THREADS) UG_NAME(bucket_drain_k)",
                          "__launch_bounds__(UG_THREADS, 4) UG_NAME(bucket_drain_k)")],
    },
    "g2": {
        "shipped": [],
        "no_prefetch": _NO_PREFETCH,
        "inline_product": [("g2_kernels.cu", "#define UG_DRAIN_F ug::Fq2Call\n",
                            "#define UG_DRAIN_F ug::Fq2\n")],
        "pair": [
            ("g2_kernels.cu", "#define UG_DRAIN_F ug::Fq2Call\n",
             '#define UG_DRAIN_F ug::Fq2Pair\n#include "drain_pair.cuh"\n'),
            ("curve_kernels.inc", _LANE, _LANE.replace(
                "(int64_t)blockIdx.x * blockDim.x + threadIdx.x",
                "((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1")),
            ("curve_kernels.inc", "UG_NAME(bucket_drain_k)<<<ug_grid(n, UG_THREADS)",
             "UG_NAME(bucket_drain_k)<<<ug_grid(n << 1, UG_THREADS)")],
    },
}


def build(tmp):
    """{(group, variant): ctypes library}, every nvcc started together, and
    the port's own cios build beside them."""
    from ultragroth_tpu_torch.ops import _build
    jobs = {}
    for g, variants in VARIANTS.items():
        for name, changes in variants.items():
            d = V.patched_csrc(tmp, f"{g}_{name}", changes,
                               {"drain_pair.cuh": PAIR_HEADER})
            jobs[(g, name)] = (os.path.join(tmp, f"{g}_{name}.so"),
                               os.path.join(d, f"{g}_kernels.cu"), [])
    return {key: V.bind(lib, f"ug_{key[0]}_bucket_drain",
                        f"ug_{key[0]}_bucket_drain_info")
            for key, (lib, _) in V.build(
                jobs, meanwhile=lambda: _build.load("cios")).items()}


def inputs(group, gen, dev):
    """(table, random-entry drain args, alternating +Q / -Q drain args)."""
    from chip_smoke import _rand_field
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.ops.curve import table_from_planes
    e = () if group == "g1" else (2,)
    n = 1 << 20
    table = table_from_planes(_rand_field((2, *e, 8, n), Q, gen, dev))
    i32 = dict(device=dev, dtype=torch.int32)
    gidx = torch.arange(LANES, **i32) * STEPS
    stride = torch.ones(LANES, **i32)
    cnt = torch.full((LANES,), STEPS, **i32)
    rand = torch.randint(0, 2 * n, (LANES, STEPS), generator=gen, device=dev)
    pid = torch.randint(0, n, (LANES, 1), generator=gen, device=dev)
    alt = pid * 2 + torch.arange(STEPS, device=dev)[None, :] % 2
    acc = _rand_field((4, *e, 8, LANES), Q, gen, dev)
    return table, acc, [
        (o.reshape(-1).to(torch.int32).contiguous(), gidx, stride, cnt)
        for o in (rand, alt)]


def run(lib, group, table, orders, acc, from_inf=False):
    """One drain of STEPS steps from `acc` (from infinity with from_inf)."""
    out = torch.empty_like(acc)
    rc = getattr(lib, f"ug_{group}_bucket_drain")(
        None if from_inf else acc.data_ptr(), out.data_ptr(),
        table.data_ptr(), *(t.data_ptr() for t in orders), 0, STEPS, LANES,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{group} drain: CUDA error {rc}")
    return out


def step_times(libs, dev):
    from chip_smoke import cuda_time_ms
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    for group, variants in VARIANTS.items():
        table, acc, (rand, alt) = inputs(group, gen, dev)
        want = {"random": run(libs[(group, "shipped")], group, table, rand, acc),
                "exceptional": run(libs[(group, "shipped")], group, table,
                                   alt, acc, True)}
        for name in variants:
            lib = libs[(group, name)]
            info = [ctypes.c_int(0) for _ in range(3)]
            getattr(lib, f"ug_{group}_bucket_drain_info")(
                *(ctypes.byref(v) for v in info))
            line = [f"{group} {name}: {info[0].value} registers, "
                    f"{info[1].value} B local (stack and spills), "
                    f"{info[2].value} blocks/SM"]
            for kind, orders, inf in (("random", rand, False),
                                      ("exceptional", alt, True)):
                if not torch.equal(run(lib, group, table, orders, acc, inf),
                                   want[kind]):
                    raise RuntimeError(f"{group} {name} ({kind}) differs "
                                       "from the shipped drain")
                ship = libs[(group, "shipped")]
                ms = [cuda_time_ms(lambda l=l: run(l, group, table, orders,
                                                   acc, inf), 3) / STEPS
                      for l in (ship, lib, lib, ship)]
                line.append(f"{kind} {(ms[1] + ms[2]) / 2:.4f} ms/step "
                            f"(shipped {(ms[0] + ms[3]) / 2:.4f} in turn)")
            print("; ".join(line), flush=True)
        del table, acc, rand, alt, want
        torch.cuda.empty_cache()


def prove_turns(libs):
    """Whole 2^20 proves with the shipped and the out_of_line_product G1
    drain in turns."""
    import chip_smoke as cs
    from ultragroth_tpu_torch.io.wtns import parse_wtns
    from ultragroth_tpu_torch.io.zkey import parse_ultragroth_zkey
    from ultragroth_tpu_torch.ops import _build
    from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                     TorchUltraGrothProver)
    from ultragroth_tpu_torch.testkit.circuits import LookupCircuit
    from ultragroth_tpu_torch.testkit.dsetup import ultragroth_setup_fast

    fns = _build.load("cios")
    other = "out_of_line_product"
    launchers = {"shipped": fns["ug_g1_bucket_drain"],
                 other: libs[("g1", other)].ug_g1_bucket_drain}

    t0 = time.perf_counter()
    zk, witness, _, _ = cs.synthetic_zkey(cs.LOG_N, cs.SEED)
    g16 = TorchGroth16Prover(zk)
    del zk
    rng = np.random.default_rng(17)
    circ = LookupCircuit(rng.integers(0, cs.UG_TABLE, size=cs.UG_CHUNKS),
                         cs.UG_TABLE)
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    st = ultragroth_setup_fast(circ.r1cs, circ.round_indexes,
                               circ.final_indexes, circ.rand_indx, seed=9)
    ugp = TorchUltraGrothProver(parse_ultragroth_zkey(
        np.frombuffer(st.zkey_bytes, np.uint8)))
    del circ, st
    torch.cuda.synchronize()
    print(f"keys and provers {time.perf_counter() - t0:.1f} s", flush=True)

    cells = {
        "groth16": lambda: g16.prove(witness, r=cs.R_BLIND, s=cs.S_BLIND),
        "ultragroth": lambda: ugp.prove(wt.values, wt, r0=cs.R0_BLIND,
                                        r=cs.R_BLIND, s=cs.S_BLIND)[0],
        }
    provers = {"groth16": g16, "ultragroth": ugp}
    for cell, prove in cells.items():
        want = None
        seconds = {v: [] for v in launchers}
        for v in launchers:                       # warm each once
            fns["ug_g1_bucket_drain"] = launchers[v]
            proof = prove().to_json()
            want = proof if want is None else want
            if proof != want:
                raise RuntimeError(f"{cell}: the {v} proof differs")
        for rnd in range(PROVE_ROUNDS[cell]):
            for v in ("shipped", other, other, "shipped"):
                fns["ug_g1_bucket_drain"] = launchers[v]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                proof = prove().to_json()
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                if proof != want:
                    raise RuntimeError(f"{cell}: the {v} proof differs")
                seconds[v].append(s)
                msm = {k: round(x, 2) for k, x in
                       provers[cell].last_phase_ms.items()
                       if k.startswith("msm") or k == "round0_commit"}
                print(f"{cell} round {rnd} {v}: {s:.4f} s {json.dumps(msm)}",
                      flush=True)
        fns["ug_g1_bucket_drain"] = launchers["shipped"]
        print(f"{cell}: " + "; ".join(
            f"{v} mean {sum(x) / len(x):.4f} s min {min(x):.4f} max "
            f"{max(x):.4f} over {len(x)}" for v, x in seconds.items()),
            flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_drain_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(V.card(), flush=True)
    with tempfile.TemporaryDirectory(prefix="ug_drain_variants_") as tmp:
        libs = build(tmp)
        step_times(libs, dev)
        if "--prove" in sys.argv[1:]:
            prove_turns(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
