"""Time the MMA field's product and the fixed-base MSM's designs apart, on one CUDA card.

    python3 tools/torch_mma_variants.py [--parent DIR]             # both parts
    python3 tools/torch_mma_variants.py --product [--parent DIR]   # the product only
    python3 tools/torch_mma_variants.py --fixed                    # the fixed-base MSM only

--product: the port's mma build (`csrc/mma_field.cuh`: raw mma.sync
m16n8k32 over ldmatrix-loaded lane rows) against builds of the same
sources with text changes (`torch_variants.py`; every nvcc started
together with the port's own six):

  parent      with --parent DIR only: DIR holds a checkout of the port
              from before this design (`git archive` of the commit before
              it, unpacked), whose `csrc/` kernel sources (.cu / .cuh) take
              the place of this tree's; there the product is WMMA 16x16x16
              tiles through shared memory, 24 tile products a warp-product
              with a constant tile loaded for each, 64-bit column-sum adds;
  fr_inline   the product inlined (`__forceinline__` for `__noinline__`)
              in the Fr kernels' source, which holds no Fq product;
  fr_min_blocks_3, fr_min_blocks_4
              the mma fr_mont_mul kernel under __launch_bounds__(256, 3)
              or (256, 4): fewer registers, more resident blocks.

Each variant's launchers take the place of the port's in the mma build's
table (`_build.load("mma")`), so the wrappers of `ops/kernels.py` launch
them; each output is held equal to the shipped build's, and each time is
taken in turns (shipped, variant, variant, shipped) with CUDA events: the
mma `fr_mont_mul` at 2^20 lanes, one Fq product's latency
(`fq_mul_chain`, one warp of dependent chains), the mma G1 / G2 drain a
step (81,920 lanes over a 2^20-point table, 256 random steps, and 256
exceptional ones), and the natural `fr_cg_ntt` pass [8, 2^10, 2^10]
(the fr_* variants: the Fr kernels only).  Prints each build's drain registers, local bytes and blocks
per SM.

--fixed: a fixed-base MSM at c = 17 over 2^20 points (`section_points`'
known-log points, a table from `msm_fixed_table`, random canonical
scalars), G1 and G2, by stage (CUDA events, the device synchronised after
each stage): the earlier path, one sort row a window, one drain over
every (window, bucket) lane and the windows folded with complete adds
(`parent_stages`, its `_fold_windows` kept below), against the merged row
of `ops/msm.py:msm_fixed_stages` at 1, 2, 4 and 8 sub-lanes a bucket, in
turns; every output equal to the earlier path's in affine.

Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import multiprocessing
import os
import sys
import tempfile

import torch

import torch_variants as V

MMA = ["-DUG_MMA_FIELD=1"]
SOURCES = ("fr_kernels.cu", "g1_kernels.cu", "g2_kernels.cu")
_FR_K = "__global__ void UG_SYM(fr_mont_mul_k)("
_MUL = "__device__ __noinline__ fe mont_mul_mma_dev("
# name: (sources built, extra files {file in csrc/: its text}, text
# changes [(file, text, replacement)], nvcc flags)
VARIANTS = {
    "fr_inline": (("fr_kernels.cu",), {}, [("mma_field.cuh", _MUL, (
        "__device__ __forceinline__ fe mont_mul_mma_dev("))], MMA),
    "fr_min_blocks_3": (("fr_kernels.cu",), {}, [("fr_kernels.cu", _FR_K, (
        "__global__ void __launch_bounds__(UG_FR_THREADS, 3) "
        "UG_SYM(fr_mont_mul_k)("))], MMA),
    "fr_min_blocks_4": (("fr_kernels.cu",), {}, [("fr_kernels.cu", _FR_K, (
        "__global__ void __launch_bounds__(UG_FR_THREADS, 4) "
        "UG_SYM(fr_mont_mul_k)("))], MMA),
}
LANES, STEPS = 20 * 4096, 256       # the drain of chip_smoke.py's phase 2
FIXED_C = 17                        # the 2^20 Groth16 tables' window
SPLITS = (1, 2, 4, 8)
ROUNDS = 2


def parent_sources(parent_dir):
    """{file: text} of the kernel sources in DIR's csrc/."""
    csrc = os.path.join(parent_dir, "ultragroth_tpu_torch", "csrc")
    out = {}
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fname)) as f:
                out[fname] = f.read()
    return out


def build(tmp, parent_dir=None):
    """{variant: {launcher ug_* name: ctypes function}} of the variants'
    libraries, built while the port's own cios and mma builds load."""
    from ultragroth_tpu_torch.ops import _build
    variants = dict(VARIANTS)
    if parent_dir is not None:
        variants["parent"] = (SOURCES, parent_sources(parent_dir), [], MMA)
    jobs = {}
    for name, (sources, files, changes, flags) in variants.items():
        d = V.patched_csrc(tmp, name, changes, files)
        for src in sources:
            jobs[(name, src)] = (os.path.join(tmp, f"{name}_{src}.so"),
                                 os.path.join(d, src), flags)

    def port():
        _build.load("cios")
        _build.load("mma")
    out = {}
    for (name, src), (lib, report) in V.build(jobs, meanwhile=port).items():
        if src == "fr_kernels.cu":
            print(f"{name}: fr_mont_mul_k {_ptxas(report, 'fr_mont_mul_k')}",
                  flush=True)
        fns = out.setdefault(name, {})
        for sym, argtypes in _build._SIGNATURES.items():
            fn = getattr(lib, "ugm_" + sym[3:], None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[sym] = fn
    return out


def _ptxas(report, kernel):
    """nvcc's -Xptxas -v lines of the entry function named *kernel*."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " | ".join(x.split(":", 1)[-1].strip()
                              for x in lines[i + 1:i + 4]
                              if "stack frame" in x or "Used" in x)
    return "not in the report"


class swapped:
    """The mma build's launchers replaced by `fns` inside the block."""

    def __init__(self, fns):
        from ultragroth_tpu_torch.ops import _build
        self.table, self.fns = _build.load("mma"), fns
        self.saved = {k: self.table[k] for k in fns}

    def __enter__(self):
        self.table.update(self.fns)

    def __exit__(self, *exc):
        self.table.update(self.saved)


def in_turns(fns, fn, reps):
    """ms of fn() under the shipped build and under `fns`, in turns
    (shipped, variant, variant, shipped); returns (shipped, variant)."""
    from chip_smoke import cuda_time_ms
    ms = []
    for which in (None, fns, fns, None):
        if which is None:
            ms.append(cuda_time_ms(fn, reps))
        else:
            with swapped(which):
                ms.append(cuda_time_ms(fn, reps))
    return (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2


def _same(fns, fn, what):
    want = fn()
    with swapped(fns):
        got = fn()
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: the variant's output differs")


def _info(fns, sym, *args):
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = fns[sym](*args, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"{sym}: CUDA error {rc}")
    return tuple(v.value for v in vals)


def product_times(libs, dev):
    from chip_smoke import _rand_field
    from torch_drain_variants import inputs
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
    from ultragroth_tpu_torch.ops import _build, kernels as K
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    shipped = _build.load("mma")
    for name, fns in [("shipped", shipped)] + list(libs.items()):
        line = [f"{name}:"]
        for g in ("g1", "g2"):
            if f"ug_{g}_bucket_drain_info" in fns:
                regs, local, blocks = _info(fns, f"ug_{g}_bucket_drain_info")
                line.append(f"{g}_bucket_drain {regs} registers, {local} B "
                            f"local, {blocks} blocks/SM;")
        regs, local, blocks = _info(fns, "ug_fr_cg_ntt_info", K.CG_MAX_LOG)
        line.append(f"fr_cg_ntt {regs} registers, {local} B local, {blocks} "
                    "blocks/SM")
        print(" ".join(line), flush=True)

    n = 1 << 20
    a = _rand_field((8, n), R, gen, dev)
    b = _rand_field((8, n), R, gen, dev)
    qa = _rand_field((8, 32), Q, gen, dev)
    qb = _rand_field((8, 32), Q, gen, dev)
    m = 1 << K.CG_MAX_LOG
    x = _rand_field((8, n), R, gen, dev).reshape(8, m, n // m).contiguous()
    tw = _rand_field((8, m // 2), R, gen, dev)
    chain = 4096
    with K.field_mode("mma"):
        for name, fns in libs.items():
            cases = {
                "fr_mont_mul 2^20 ms": (lambda: K.fr_mont_mul(a, b), 50, 1),
                "fr_cg_ntt natural [8, 2^10, 2^10] ms": (
                    lambda: K.fr_cg_ntt(x, tw), 20, 1)}
            if name == "parent":
                cases["Fq product latency us"] = (
                    lambda: K.fq_mul_chain(qa, qb, chain), 5, 1e3 / chain)
            for what, (fn, reps, scale) in cases.items():
                _same(fns, fn, f"{name} {what}")
                s, v = in_turns(fns, fn, reps)
                print(f"{name}: {what} {v * scale:.4f} (shipped "
                      f"{s * scale:.4f} in turn)", flush=True)
            if name != "parent":
                continue
            for group in ("g1", "g2"):
                table, acc, (rand, alt) = inputs(group, gen, dev)
                for kind, orders, start in (("random", rand, acc),
                                            ("exceptional", alt, None)):
                    def drain():
                        return K.curve_bucket_drain(group, table, *orders, 0,
                                                    STEPS, acc=start)
                    _same(fns, drain, f"{name} {group} drain {kind}")
                    s, v = in_turns(fns, drain, 3)
                    print(f"{name}: {group}_bucket_drain {kind} "
                          f"{v / STEPS:.4f} ms/step (shipped "
                          f"{s / STEPS:.4f} in turn)", flush=True)
                del table, acc, rand, alt
                torch.cuda.empty_cache()


# -- the fixed-base MSM's earlier path: a sort row a window, the windows
#    folded with complete adds -------------------------------------------------

def _add_all(group, a, b):
    """Complete add of two xyzz batches of any trailing batch shape."""
    from ultragroth_tpu_torch.ops import kernels as K
    shape = a.shape
    lead = tuple(shape[:2 if group == "g1" else 3])      # [4, *elem]
    out = K.curve_add_where(group, a.reshape(lead + (-1,)).contiguous(),
                            b.reshape(lead + (-1,)).contiguous())
    return out.reshape(shape)


def _fold_windows(group, acc):
    """[4, *elem, W, nb] -> [4, *elem, 1, nb]: the window axis summed with
    complete adds (padded with infinity to a power of two)."""
    from ultragroth_tpu_torch.ops.curve import curve_ops
    ops = curve_ops(group)
    w = acc.shape[-2]
    m = 1 << max(1, (w - 1).bit_length())
    if m > w:
        pad = ops.inf_xyzz((m - w, acc.shape[-1]), acc.device, acc.dtype)
        acc = torch.cat([acc, pad], dim=-2)
    while acc.shape[-2] > 1:
        acc = _add_all(group, acc[..., 0::2, :], acc[..., 1::2, :])
    return acc


def parent_stages(group, table, inf, scalars, c):
    """The earlier `msm_fixed` as stages: (digits and the W-row sort,
    index math, the drain of W x 2^(c-1) lanes, the fold, the reduction).
    scalars [8, Npad]."""
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops import msm as M
    from ultragroth_tpu_torch.ops.limbs import widen
    size = inf.shape[0]
    nw = M.fixed_n_windows(c)
    dev = table.device
    orders, counts = M._sort_buckets(
        *M._signed_digits(widen(scalars), c, nw), inf, c,
        torch.arange(nw * size, device=dev).reshape(nw, size))
    yield "digits_sort", (orders, counts)
    lanes = M._drain_lanes(size, counts, c, [1] * nw)
    yield "index_math", lanes
    acc = M._drain(group, table, orders, lanes)
    yield "drain", acc
    acc = _fold_windows(group, acc)
    yield "fold", acc
    yield "reduce", K.curve_bucket_reduce(group, acc, [1])[..., 0]


def merged_stages(group, table, inf, scalars, c, split):
    """`msm_fixed_stages` with `split` sub-lanes a bucket in place of
    `FIXED_SPLIT`."""
    from ultragroth_tpu_torch.ops import msm as M
    saved, M.FIXED_SPLIT = M.FIXED_SPLIT, split
    try:
        yield from M.msm_fixed_stages(group, table, inf, scalars, c)
    finally:
        M.FIXED_SPLIT = saved


def fixed_times(dev, log_n=20):
    import chip_smoke as cs
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops import msm as M
    from ultragroth_tpu_torch.ops.curve import curve_ops
    n = 1 << log_n
    specs = [("g1", 3, 5, 7, n), ("g2", 11, 13, 17, n)]
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        words = pool.map(cs.section_points, specs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    scalars = cs._rand_field((8, n), R, gen, dev)
    for (group, *_), w in zip(specs, words):
        ops = curve_ops(group)
        shape = (n, 2, 8) if group == "g1" else (n, 2, 2, 8)
        pts = torch.from_numpy(w.view("<i4").reshape(shape).copy()).to(dev)
        table, inf, c = M.msm_fixed_table(
            group, pts, torch.zeros(n, dtype=torch.bool, device=dev),
            FIXED_C)
        del pts
        runs = {"parent": lambda: parent_stages(group, table, inf, scalars,
                                                c)}
        for s in SPLITS:
            runs[f"split_{s}"] = (lambda s=s: merged_stages(
                group, table, inf, scalars, c, s))
        order = list(runs) + list(runs)[::-1]
        ms = {k: [] for k in runs}
        want = None
        for rnd in range(ROUNDS + 1):          # round 0 warms up
            for k in order:
                split, out = cs._staged(runs[k]())
                aff = ops.to_affine(out[..., None])
                if want is None:
                    want = aff
                elif not all(torch.equal(x, y) for x, y in zip(aff, want)):
                    raise RuntimeError(f"{group} {k}: the MSM differs from "
                                       "the earlier path's")
                if rnd:
                    ms[k].append(split)
        for k, splits in ms.items():
            mean = {st: sum(d[st] for d in splits) / len(splits)
                    for st in splits[0]}
            work = {st: v for st, v in mean.items()
                    if st in ("drain", "fold", "reduce")}
            print(f"{group} fixed-base 2^{log_n} MSM, c = {c}, {k}: "
                  f"{json.dumps({st: round(v, 4) for st, v in mean.items()})}"
                  f"; drain + fold + reduce {sum(work.values()):.4f} ms; all "
                  f"stages {sum(mean.values()):.4f} ms (mean of "
                  f"{len(splits)})", flush=True)
        print(f"{group}: every output equal to the earlier path's in "
              "affine", flush=True)
        del table, inf
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    argv = sys.argv[1:]
    parent_dir = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent_dir = os.path.abspath(argv[i + 1])
        del argv[i:i + 2]
    args = set(argv) or {"--product", "--fixed"}
    print(V.card(), flush=True)
    if "--product" in args:
        with tempfile.TemporaryDirectory(prefix="ug_mma_variants_") as tmp:
            product_times(build(tmp, parent_dir), dev)
    if "--fixed" in args:
        fixed_times(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
