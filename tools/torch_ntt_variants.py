"""Time the parts and the design choices of the port's NTT kernel apart, on
one CUDA card.

    python3 tools/torch_ntt_variants.py [--old] [--new]

--old times the earlier kernel's parts, --new the shipped kernel's
variants; neither: both.

Every variant is compiled with plain nvcc (cios build, one process each, all
started together) and run at the shape `ntt_fast` gives the kernel at 2^20:
[8, 2^10, 2^10], 2^10 columns of 2^10 points.

The earlier kernel (the constant-geometry network, one butterfly a
thread a stage, every stage between two barriers; its source is OLD_SOURCE
below, a copy) in parts, each a build of the same source:

  full           as it shipped: the strided column load, the ten stages
                 with their twiddles from global memory, the bit-reversed
                 strided store;
  copy           a contiguous load of the block's 32 KB into shared memory
                 and a contiguous store: the floor of the others;
  load           the strided load, then the contiguous store;
  store          the contiguous load, then the bit-reversed strided store;
  stages         the contiguous load, the stages, the contiguous store;
  stages_smem_tw the same with the twiddles read from a table of w^0 ..
                 w^511 staged in shared memory (exponents from global);
  stages_no_tw   the same with one twiddle in registers (no table read).

A part's cost is its time less the copy's.  `full` is held equal, on four
columns, to the port's base-mode NTT of each.

--new times the shipped kernel (`csrc/fr_kernels.cu`, `ug_fr_cg_ntt`) in
builds from copies of `csrc/` with the other choices of its design
(NEW_VARIANTS): 256 threads a block, the Fr product inlined at every call
site, the twiddles from the global table, the points' loads with an L2
prefetch of 256 B, each output held equal to the shipped build's; and
probes, timed only: each with one part taken away (the global loads,
the global stores, the arithmetic, the twiddles' negation, the exchanges
through shared memory), `probe_io` with the global I/O alone, and the
`runs_32` probes, with the same bytes moved in runs of 32 B (a warp's
load or store: 8 adjacent columns of 4 rows) in place of the kernel's
16 B (4 columns of 8 rows): whole, without the arithmetic, and the I/O
alone.  Each with and without the folded split twiddle and transposed
store.  Timed in turns (reference, variant, variant, reference) with CUDA
events; prints the card, each build's registers, local (spill) bytes and
blocks per SM, and ms a launch.  The builds: tools/torch_variants.py.
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import torch

import torch_variants as V

LOG_M = 10
REPS = 20

OLD_PARTS = ("full", "copy", "load", "store", "stages", "stages_smem_tw",
             "stages_no_tw")

# The earlier kernel (csrc/fr_kernels.cu and curve.cuh's cg_butterfly /
# cg_store as they were, renamed), its shared memory made dynamic so that
# every part builds from one text.  PART selects what runs: bit 0 the strided load,
# bit 1 the stages, bit 2 the strided store; TW 0 twiddles from global
# memory, 1 from the shared table, 2 none.
OLD_SOURCE = r"""
#include "launch_common.cuh"
#define ELEMS 1024
namespace {
using ug::fe;
using ug::Fr;
__device__ __forceinline__ void old_butterfly(const uint32_t* a, const uint32_t* tw,
    int64_t n, int64_t m, int64_t cols, int64_t b, fe& hi, fe& lo,
    const uint32_t* spw, const uint16_t* ex, const fe& reg_tw) {
  const int64_t i = b / cols, c = b - i * cols;
  const fe u = ug::load(a, n, i * cols + c, 0);
  fe w;
#if TW == 0
  w = ug::load(tw, m / 2, i, 0);
#elif TW == 1
  w = ug::load(spw, 512, ex[i], 0);
#else
  w = reg_tw;
#endif
  const fe t = Fr::mul(ug::load(a, n, (i + m / 2) * cols + c, 0), w);
  hi = Fr::add(u, t);
  lo = Fr::sub(u, t);
}
__device__ __forceinline__ void old_store(uint32_t* a, int64_t n, int64_t cols,
                                         int64_t b, const fe& hi, const fe& lo) {
  const int64_t i = b / cols, c = b - i * cols;
  ug::store(a, n, 2 * i * cols + c, 0, hi);
  ug::store(a, n, (2 * i + 1) * cols + c, 0, lo);
}
}  // namespace

extern __shared__ __align__(16) uint32_t old_smem[];

__global__ void __launch_bounds__(ELEMS / 2)
old_k(const uint32_t* x, const uint32_t* tw, const uint32_t* pw, const uint16_t* ex,
      uint32_t* y, int log_m, int64_t cb, int cols) {
  uint32_t* s = old_smem;
  uint32_t* spw = s + 8 * ELEMS;
  const int m = 1 << log_m;
  const int nb = cols * m;
  const int64_t c0 = (int64_t)blockIdx.x * cols;
  const int64_t flat = (int64_t)blockIdx.x * 8 * nb;
#if TW == 1
  for (int k = threadIdx.x; k < 8 * 512; k += blockDim.x) spw[k] = pw[k];
#endif
  for (int k = threadIdx.x; k < 8 * nb; k += blockDim.x) {
#if PART & 1
    const int l = k / nb, e = k - l * nb, j = e / cols, cc = e - j * cols;
    const int64_t c = c0 + cc;
    s[k] = c < cb ? x[((int64_t)l * m + j) * cb + c] : 0u;
#else
    s[k] = x[flat + k];
#endif
  }
  __syncthreads();
#if PART & 2
  const int b = threadIdx.x;
  fe reg_tw = ug::load(tw, m / 2, b & (m / 2 - 1), 0);
  for (int st = 0; st < log_m; st++) {
    fe hi, lo;
    if (b < nb / 2)
      old_butterfly(s, tw + (int64_t)st * 8 * (m / 2), nb, m, cols, b, hi, lo, spw,
                   ex + st * (m / 2), reg_tw);
    __syncthreads();
    if (b < nb / 2) old_store(s, nb, cols, b, hi, lo);
    __syncthreads();
  }
#endif
  for (int k = threadIdx.x; k < 8 * nb; k += blockDim.x) {
#if PART & 4
    const int l = k / nb, e = k - l * nb, j = e / cols, cc = e - j * cols;
    const int64_t c = c0 + cc;
    const int rj = (int)(__brev((unsigned)j) >> (32 - log_m));
    if (c < cb) y[((int64_t)l * m + rj) * cb + c] = s[k];
#else
    y[flat + k] = s[k];
#endif
  }
}

extern "C" int old_ntt(const void* x, const void* tw, const void* pw, const void* ex,
                       void* y, int log_m, int64_t cb, void* stream) {
  const int cols = ELEMS >> log_m;
  const int64_t blocks = (cb + cols - 1) / cols;
  const int smem = 4 * 8 * ELEMS + (TW == 1 ? 4 * 8 * 512 : 0);
  if (cudaError_t e = cudaFuncSetAttribute(
          old_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  old_k<<<(unsigned)blocks, ELEMS / 2, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)pw,
      (const uint16_t*)ex, (uint32_t*)y, log_m, cb, cols);
  return (int)cudaGetLastError();
}

extern "C" int old_info(int* regs, int* local_bytes) {
  cudaFuncAttributes at;
  if (cudaError_t e = cudaFuncGetAttributes(&at, old_k)) return (int)e;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}
"""

_OLD_DEFINES = {
    "full": (7, 0), "copy": (0, 0), "load": (1, 0), "store": (4, 0),
    "stages": (2, 0), "stages_smem_tw": (2, 1), "stages_no_tw": (2, 2),
}

# The shipped kernel's builds, each a copy of csrc/ with text changes
# (file, old, new): the other choices of its design, and the probes that
# take one part away (their outputs are not the NTT: timed only).  The
# reference is the build the port makes.
_NTT = "ntt.cuh"
_NO_COMPUTE = [
    (_NTT, "    ntt_dft<LOG_N, B, G>(v + g, tw);", ""),
    (_NTT, "        v[g + r * G] = UG_NTT_F::mul(v[g + r * G], "
           "tw(r * k * (S::N / (NS * R))));", ";")]
_NO_EXCHANGE = [
    (_NTT, "v[i].v[l] = sdat[S::sidx(l, ln.t + i * S::T, ln.c)];",
     "v[i].v[l] += (uint32_t)ln.c;"),
    (_NTT, "for (int l = 0; l < 8; l++) sdat[S::sidx(l, p, ln.c)] = v[Ps::slot(g, q)].v[l];",
     "(void)p;")]
# Global traffic in runs of 32 B (a warp: 8 adjacent columns x 4 rows) in
# place of 16 B (4 columns x 8 rows), the same bytes over the launch: at
# 2^10 points and 512 threads, block b moves columns (b >> 1)*8 .. + 8 of
# rows (b & 1)*512 .. + 512, thread tid column tid & 7 of rows (tid >> 3)
# + 64 i.  The points are not a column's, so the output is not the NTT.
# Loads and natural stores; the folded pass's stores are runs of 32 B
# already.
_RUNS_32 = [
    (_NTT, "  int c, t;\n  int64_t col;\n  bool live;",
     "  int c, t, rt;\n  int64_t col, rc;\n  bool live;"),
    (_NTT, "    col = live ? raw : cols - 1;\n",
     "    col = live ? raw : cols - 1;\n"
     "    rt = (int)((blk & 1) << (LOG_N - 1)) + (tid >> 3);\n"
     "    rc = (blk >> 1) * 8 + (tid & 7);\n"
     "    if (rc >= cols) rc = cols - 1;\n"),
    (_NTT, "v[i].v[l] = a.x[((int64_t)l * S::N + ln.t + i * S::T) * a.cols + ln.col];",
     "v[i].v[l] = a.x[((int64_t)l * S::N + ln.rt + i * (UG_NTT_THREADS / 8)) "
     "* a.cols + ln.rc];"),
    (_NTT, ": ((int64_t)l * S::N + k) * a.cols + ln.col;",
     ": ((int64_t)l * S::N + ln.rt + (g + q * Ps::G) * (UG_NTT_THREADS / 8)) "
     "* a.cols + ln.rc;")]
NEW_VARIANTS = {
    "shipped": [],
    "threads_256": [(_NTT, "#else\n#define UG_NTT_THREADS 512",
                     "#else\n#define UG_NTT_THREADS 256")],
    "inline_product": [(_NTT, "#define UG_NTT_F ug::FieldCall<ug::FrParams>",
                        "#define UG_NTT_F ug::Fr")],
    "global_twiddles": [(_NTT, "const NttTw<LOG_N, true> tw{stws};",
                         "const NttTw<LOG_N, false> tw{a.tw};")],
    "l2_prefetch_256": [
        (_NTT, "namespace ug {\n\ntemplate <int LOG_N>\nstruct NttShape {",
         "namespace ug {\n\nUG_HD uint32_t ntt_ldg(const uint32_t* p) {\n"
         "#if defined(__CUDA_ARCH__)\n  uint32_t r;\n"
         "  asm volatile(\"ld.global.nc.L2::256B.u32 %0, [%1];\" : \"=r\"(r) : \"l\"(p));\n"
         "  return r;\n#else\n  return *p;\n#endif\n}\n\n"
         "template <int LOG_N>\nstruct NttShape {"),
        (_NTT, "v[i].v[l] = a.x[((int64_t)l * S::N + ln.t + i * S::T) * a.cols + ln.col];",
         "v[i].v[l] = ntt_ldg(a.x + ((int64_t)l * S::N + ln.t + i * S::T) * a.cols + ln.col);")],
    "probe_no_load": [(
        _NTT, "v[i].v[l] = a.x[((int64_t)l * S::N + ln.t + i * S::T) * a.cols + ln.col];",
        "v[i].v[l] = (uint32_t)(ln.t * 8 + i + l) ^ (uint32_t)ln.col;")],
    "probe_no_store": [(
        _NTT, "      a.y[at] = r.v[l];",
        "      if (r.v[l] == 0x9e3779b9u) a.y[at] = r.v[l];")],
    "probe_no_compute": _NO_COMPUTE,
    "probe_no_negation": [(
        _NTT, "const uint32_t neg = (e & S::H) ? ~0u : 0u;",
        "const uint32_t neg = 0u;")],
    "probe_no_exchange": _NO_EXCHANGE,
    "probe_io": _NO_COMPUTE + _NO_EXCHANGE,
    "probe_runs_32": _RUNS_32,
    "probe_runs_32_no_compute": _NO_COMPUTE + _RUNS_32,
    "probe_io_runs_32": _NO_COMPUTE + _NO_EXCHANGE + _RUNS_32,
}


def build(tmp, old, new):
    """{name: ctypes library} of the earlier kernel's parts (old) and of
    the shipped kernel's variants (new); every nvcc started together."""
    from ultragroth_tpu_torch.ops import _build
    jobs = {}
    if old:
        old_src = os.path.join(tmp, "old_ntt.cu")
        with open(old_src, "w") as f:
            f.write(OLD_SOURCE)
        for part, (bits, tw) in _OLD_DEFINES.items():
            jobs[f"old:{part}"] = (os.path.join(tmp, f"old_{part}.so"), old_src,
                                   [f"-I{_build.CSRC}", f"-DPART={bits}",
                                    f"-DTW={tw}"])
    if new:
        for name, changes in NEW_VARIANTS.items():
            d = V.patched_csrc(tmp, f"csrc_{name}", changes)
            jobs[f"new:{name}"] = (os.path.join(tmp, f"new_{name}.so"),
                                   os.path.join(d, "fr_kernels.cu"), [])
    libs = {}
    for key, (lib, report) in V.build(jobs).items():
        # ptxas's report of the 2^10 instance (or of the only kernel)
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (key.startswith("old:") or
                                              "ILi10E" in line):
                for rep in lines[i + 1:i + 4]:
                    if "registers" in rep or "spill" in rep:
                        print(f"  {key} ptxas: {rep.strip()}", flush=True)
        if key.startswith("old:"):
            lib.old_ntt.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
            lib.old_ntt.restype = ctypes.c_int
            lib.old_info.argtypes = [ctypes.c_void_p] * 2
        else:
            V.bind(lib, "ug_fr_cg_ntt", "ug_fr_cg_ntt_info")
        libs[key] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def old_parts(libs, dev, x):
    from chip_smoke import HBM_BYTES_PER_S, IMAD_PER_S, MUL_IMAD, cuda_time_ms
    from ultragroth_tpu_torch.ops import kernels as K
    from ultragroth_tpu_torch.ops import ntt as N
    from ultragroth_tpu_torch.protocol.transcript import root_of_unity
    m = 1 << LOG_M
    cb = x.shape[2]
    dom = N.Domain(LOG_M, dev)
    tw = dom.cg_twiddles(LOG_M, False)
    pw = N._powers(root_of_unity(LOG_M), m // 2, dev)
    ex = torch.stack(K.cg_exponents(LOG_M)).to(torch.int16).to(dev)
    y = torch.empty_like(x)

    def run(lib):
        rc = lib.old_ntt(x.data_ptr(), tw.data_ptr(), pw.data_ptr(),
                         ex.data_ptr(), y.data_ptr(), LOG_M, cb, _stream())
        if rc != 0:
            raise RuntimeError(f"old kernel: CUDA error {rc}")

    run(libs["old:full"])
    torch.cuda.synchronize()
    for c in (0, 1, cb // 2, cb - 1):
        want = N.ntt(x[:, :, c].contiguous(), dom)
        if not torch.equal(y[:, :, c], want):
            raise RuntimeError(f"old kernel: column {c} differs from the "
                               "base-mode NTT")
    bound = max(2 * 32 * m * cb / HBM_BYTES_PER_S,
                LOG_M * (m // 2) * cb * MUL_IMAD / IMAD_PER_S) * 1e3
    times = {}
    for part in OLD_PARTS:
        lib = libs[f"old:{part}"]
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        lib.old_info(ctypes.byref(regs), ctypes.byref(local))
        ref = libs["old:full"]
        ms = [cuda_time_ms(lambda l=l: run(l), REPS) for l in (ref, lib, lib, ref)]
        times[part] = (ms[1] + ms[2]) / 2
        print(f"old {part}: {times[part]:.4f} ms a launch (full in turn "
              f"{(ms[0] + ms[3]) / 2:.4f}); {regs.value} registers, "
              f"{local.value} B local", flush=True)
    for part in ("load", "store", "stages"):
        print(f"old {part} less copy: {times[part] - times['copy']:.4f} ms",
              flush=True)
    print(f"old twiddles: global {times['stages']:.4f} shared "
          f"{times['stages_smem_tw']:.4f} none {times['stages_no_tw']:.4f} "
          f"ms; bound {bound:.4f} ms", flush=True)


def new_variants(libs, dev, x):
    from chip_smoke import cuda_time_ms
    from ultragroth_tpu_torch.ops import ntt as N
    cols = x.shape[2]
    dom = N.Domain(LOG_M, dev)
    tw = dom.ntt_twiddles(LOG_M, False)
    stw = dom.split_twiddles(LOG_M, LOG_M, False)
    ref = libs["new:shipped"]
    for fold in (False, True):
        args = (stw.data_ptr(), 1) if fold else (None, 0)

        def run(lib, out):
            rc = lib.ug_fr_cg_ntt(x.data_ptr(), tw.data_ptr(), args[0],
                                  out.data_ptr(), LOG_M, cols, args[1],
                                  _stream())
            if rc != 0:
                raise RuntimeError(f"fr_cg_ntt variant: CUDA error {rc}")

        want = torch.empty_like(x)
        run(ref, want)
        for name in NEW_VARIANTS:
            lib = libs[f"new:{name}"]
            probe = name.startswith("probe_")
            info = [ctypes.c_int(0) for _ in range(3)]
            lib.ug_fr_cg_ntt_info(LOG_M, *(ctypes.byref(v) for v in info))
            got = torch.empty_like(x)
            run(lib, got)
            torch.cuda.synchronize()
            if not probe and not torch.equal(got, want):
                raise RuntimeError(f"fr_cg_ntt {name} differs from the "
                                   "shipped build")
            ms = [cuda_time_ms(lambda l=l: run(l, got), REPS)
                  for l in (ref, lib, lib, ref)]
            print(f"new {name} {'fold+transposed' if fold else 'natural'}: "
                  f"{(ms[1] + ms[2]) / 2:.4f} ms a launch (shipped in turn "
                  f"{(ms[0] + ms[3]) / 2:.4f}); {info[0].value} registers, "
                  f"{info[1].value} B local, {info[2].value} blocks/SM",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ntt_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _rand_field
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    dev = torch.device("cuda")
    print(V.card(), flush=True)
    old, new = "--old" in sys.argv[1:], "--new" in sys.argv[1:]
    if not (old or new):
        old = new = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    m = 1 << LOG_M
    x = _rand_field((8, m * m), R, gen, dev).reshape(8, m, m).contiguous()
    with tempfile.TemporaryDirectory(prefix="ug_ntt_variants_") as tmp:
        libs = build(tmp, old, new)
        if old:
            old_parts(libs, dev, x)
        if new:
            new_variants(libs, dev, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
