"""Build and load the CUDA kernels of `csrc/`: plain `nvcc` into shared
libraries with a C interface, loaded with `ctypes`.

The twin of the JAX package's `ops/fuse.py` in role (the place kernels are
made), not in form: `fused_map` traced a formula into a Pallas kernel; here
each `csrc/*.cu` source is compiled once, at first use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

with one `nvcc` process per source, all started together.  The output goes
to the compile cache (`runtime.compile_cache_dir()`: ULTRAGROTH_COMPILE_CACHE,
default `ultragroth_tpu_torch/_build/`, ignored by git) under a name that
carries a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once.  `nvcc`'s own report (registers, spills of
every kernel, from `-Xptxas -v`) is kept beside each library as
`<name>-<hash>.log`.  No PyTorch header is compiled: a source with a plain
C interface builds in seconds, one that includes PyTorch's takes minutes.

Every source is built in two field modes (`MODES`): `cios`, the default,
and `mma`, with -DUG_MMA_FIELD=1: the same kernels with the Montgomery
reduction on the tensor cores (`csrc/mma_field.cuh`, the twin of
ULTRAGROTH_MXU_FIELD), whose launchers are named ugm_* instead of ug_*.
A mode's libraries are built at its first use (`load(mode)`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fr_kernels.cu", "g1_kernels.cu", "g2_kernels.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MODES = {"cios": [], "mma": ["-DUG_MMA_FIELD=1"]}

_lock = threading.Lock()
_libs: dict = {}             # mode -> {launcher name: ctypes function}
_handles: list = []          # the CDLLs stay loaded while their functions live


def build_dir() -> Path:
    from ..runtime import compile_cache_dir
    return compile_cache_dir()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(source: str, mode: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + MODES[mode]).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".inc"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(source.encode())
    return h.hexdigest()[:16]


def library_path(source: str, mode: str = "cios") -> Path:
    suffix = "" if mode == "cios" else f"_{mode}"
    return build_dir() / f"{Path(source).stem}{suffix}-{_digest(source, mode)}.so"


def build(modes=("cios",)) -> dict:
    """Compile every stale (source, mode) in parallel; return {(source,
    mode): .so path}.

    Prints the seconds the build took.  Raises with nvcc's output when a
    source does not compile."""
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    outs, procs = {}, []
    for mode in modes:
        for src in SOURCES:
            so = library_path(src, mode)
            outs[(src, mode)] = so
            if not so.exists():
                procs.append(_start(src, mode, so))
    failed, done = [], {}
    while len(done) < len(procs):
        for src, so, tmp, log, proc in procs:
            if src in done or proc.poll() is None:
                continue
            done[src] = time.perf_counter() - t0
            out = log.read_bytes()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, so)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    if procs:
        print(f"[ultragroth_tpu_torch] built {len(procs)} kernel sources in "
              f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
                  f"{k} {v:.1f} s" for k, v in done.items()),
              file=sys.stderr, flush=True)
    return outs


def _start(src: str, mode: str, so: Path):
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    log = so.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, *MODES[mode], "-o", str(tmp), str(CSRC / src)]
    with open(log, "wb") as out:     # nvcc's report goes straight to the log
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return (f"{src} ({mode})", so, tmp, log, proc)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "ug_fr_mont_mul": [_P, _P, _P, _I64, _I64, _P],
    "ug_fr_butterfly": [_P, _P, _I64, _I64, _P],
    "ug_fr_cg_ntt": [_P, _P, _P, _P, ctypes.c_int, _I64, _I64, _P],
    "ug_fr_cg_ntt_info": [ctypes.c_int, _P, _P, _P],
    "ug_fq_mont_mul": [_P, _P, _P, _I64, _P],
    "ug_fq_chain": [_P, _P, _P, _I64, _I32, _P],
}
for _g in ("g1", "g2"):
    _SIGNATURES.update({
        f"ug_{_g}_bucket_drain": [_P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                                  _I64, _P],
        f"ug_{_g}_bucket_drain_info": [_P, _P, _P],
        f"ug_{_g}_fixed_base_mul": [_P, _P, _I64, _P, _P, _P, _I64, _P],
        f"ug_{_g}_window_table": [_P, _P, _P, _I64, ctypes.c_int,
                                  ctypes.c_int, _P],
        f"ug_{_g}_chain_info": [ctypes.c_int, _P, _P, _P],
        f"ug_{_g}_add_where": [_P, _P, _P, _P, _I64, _P],
        f"ug_{_g}_reduce_step": [_P, _I64, _P, _I64, _P, ctypes.c_int, _I64,
                                 _P],
        f"ug_{_g}_reduce_tail": [_P, _I64, _P, ctypes.c_int, _I64,
                                 ctypes.c_int, ctypes.c_int, _P, _I64, _P],
        f"ug_{_g}_window_combine": [_P, _I64, ctypes.c_int, _P, _P, _P, _P],
        f"ug_{_g}_reduce_info": [ctypes.c_int] * 3 + [_P, _P, _P],
    })


def drain_info(mode: str = "cios") -> dict:
    """{group: (registers, local bytes a thread, resident 128-thread blocks
    per SM)} of the `mode` build's bucket drain kernels."""
    fns = load(mode)
    out = {}
    for g in ("g1", "g2"):
        vals = [ctypes.c_int(0) for _ in range(3)]
        rc = fns[f"ug_{g}_bucket_drain_info"](*(ctypes.byref(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"{g}_bucket_drain ({mode}): CUDA error {rc}")
        out[g] = tuple(v.value for v in vals)
    return out


def ntt_info(mode: str, log_m: int) -> tuple:
    """(registers, local bytes a thread, resident blocks per SM) of the
    `mode` build's fr_cg_ntt instance for columns of 2^log_m points."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = load(mode)["ug_fr_cg_ntt_info"](log_m, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"fr_cg_ntt ({mode}): CUDA error {rc}")
    return tuple(v.value for v in vals)


REDUCE_KINDS = ("reduce_step", "reduce_tail", "window_combine")


def reduce_info(mode: str, tail_u: int, tail_arrays: int,
                windows: int) -> dict:
    """{(group, kernel): (registers, local bytes a thread, resident blocks
    per SM)} of the `mode` build's reduction kernels (REDUCE_KINDS), the
    tail at width tail_u with tail_arrays arrays, the combine of `windows`
    windows."""
    fns = load(mode)
    out = {}
    for g in ("g1", "g2"):
        for kind, name in enumerate(REDUCE_KINDS):
            a, b = ((0, 0), (tail_u, tail_arrays), (windows, 0))[kind]
            vals = [ctypes.c_int(0) for _ in range(3)]
            rc = fns[f"ug_{g}_reduce_info"](kind, a, b,
                                             *(ctypes.byref(v) for v in vals))
            if rc != 0:
                raise RuntimeError(f"{g}_{name} ({mode}): CUDA error {rc}")
            out[(g, name)] = tuple(v.value for v in vals)
    return out


CHAIN_KINDS = ("fixed_base_mul", "window_table")


def chain_info(mode: str = "cios") -> dict:
    """{(group, kernel): (registers, local bytes a thread, resident blocks
    per SM)} of the `mode` build's per-key chain kernels (CHAIN_KINDS)."""
    fns = load(mode)
    out = {}
    for g in ("g1", "g2"):
        for kind, name in enumerate(CHAIN_KINDS):
            vals = [ctypes.c_int(0) for _ in range(3)]
            rc = fns[f"ug_{g}_chain_info"](kind, *(ctypes.byref(v) for v in vals))
            if rc != 0:
                raise RuntimeError(f"{g}_{name} ({mode}): CUDA error {rc}")
            out[(g, name)] = tuple(v.value for v in vals)
    return out


def load(mode: str = "cios") -> dict:
    """{launcher name (ug_*): ctypes function} of one field mode, building
    first if needed.  The mma libraries export the same launchers as
    ugm_*; they are returned under the ug_* names."""
    if mode not in MODES:
        raise ValueError(f"unknown field mode {mode!r}")
    with _lock:
        if mode not in _libs:
            fns = {}
            for so in build((mode,)).values():
                lib = ctypes.CDLL(str(so))
                _handles.append(lib)
                for name, argtypes in _SIGNATURES.items():
                    sym = name if mode == "cios" else "ugm_" + name[3:]
                    fn = getattr(lib, sym, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name] = fn
            missing = set(_SIGNATURES) - set(fns)
            if missing:
                raise RuntimeError(f"kernel launchers missing ({mode}): "
                                   f"{sorted(missing)}")
            _libs[mode] = fns
        return _libs[mode]
