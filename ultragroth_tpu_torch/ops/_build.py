"""Build and load the CUDA kernels of `csrc/`: plain `nvcc` into shared
libraries with a C interface, loaded with `ctypes`.

The twin of the JAX package's `ops/fuse.py` in role (the place kernels are
made), not in form: `fused_map` traced a formula into a Pallas kernel; here
each `csrc/*.cu` source is compiled once, at first use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

with one `nvcc` process per source, all started together.  The output goes
to `ultragroth_tpu_torch/_build/` (ignored by git) under a name that carries
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once.  `nvcc`'s own report (registers, spills of
every kernel, from `-Xptxas -v`) is kept beside each library as
`<name>-<hash>.log`.  No PyTorch header is compiled: a source with a plain
C interface builds in seconds, one that includes PyTorch's takes minutes.
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
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fr_kernels.cu", "g1_kernels.cu", "g2_kernels.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict | None = None
_handles: list = []          # the CDLLs stay loaded while their functions live


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".inc"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(source.encode())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every stale source in parallel; return {source: .so path}.

    Prints the seconds the build took.  Raises with nvcc's output when a
    source does not compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    outs, procs = {}, []
    for src in SOURCES:
        so = BUILD_DIR / f"{Path(src).stem}-{_digest(src)}.so"
        outs[src] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        log = so.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, so, tmp, log,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, so, tmp, log, proc in procs:
        out, _ = proc.communicate()
        log.write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    if procs:
        print(f"[ultragroth_tpu_torch] built {len(procs)} kernel sources in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return outs


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "ug_fr_mont_mul": [_P, _P, _P, _I64, _I64, _P],
    "ug_fr_butterfly": [_P, _P, _I64, _I64, _P],
    "ug_fr_cg_ntt": [_P, _P, _P, ctypes.c_int, _I64, _P],
}
for _g in ("g1", "g2"):
    _SIGNATURES.update({
        f"ug_{_g}_madd_fast": [_P, _P, _P, _I64, _P, _P, _P, _P, _I32, _P,
                               _P, _I64, _P],
        f"ug_{_g}_madd_signed": [_P, _P, _P, _I64, _P, _P, _P, _P, _I32,
                                 _I64, _P],
        f"ug_{_g}_madd_valid": [_P, _P, _P, _P, _I64, _P, ctypes.c_int,
                                _I64, _P],
        f"ug_{_g}_add_where": [_P, _P, _P, _P, _I64, _P],
        f"ug_{_g}_horner": [_P, _I64, ctypes.c_int, _P],
    })


def load() -> dict:
    """{launcher name: ctypes function}, building first if needed."""
    global _libs
    with _lock:
        if _libs is None:
            fns = {}
            for so in build().values():
                lib = ctypes.CDLL(str(so))
                _handles.append(lib)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name] = fn
            missing = set(_SIGNATURES) - set(fns)
            if missing:
                raise RuntimeError(f"kernel launchers missing: {sorted(missing)}")
            _libs = fns
        return _libs
