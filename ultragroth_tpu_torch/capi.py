"""Thin adapters consumed by the port's embedded-C ABI shim
(`csrc/capi_shim.cpp`, the twin of the JAX package's `capi.py` and
`native/ultragroth_capi.cpp`).  All functions take/return only C-friendly
types (bytes in, str/int out).

`build_libraries()` compiles, at first use, into the port's build
directory (`runtime.compile_cache_dir()`):

  * `libultragroth.so`: the shim, by g++ with the embedded interpreter's
    flags (native/Makefile's PYINC / PYLD / PYLIB, read from `sysconfig`);
    a C consumer includes `native/include/ultragroth/prover.h` and
    `verifier.h`, links `-L<dir> -lultragroth`, and runs with PYTHONPATH
    at the repository (and ULTRAGROTH_PLATFORM=cpu to prove on the CPU);
  * `libultragroth_remote.so`: `native/ultragroth_remote.c` unchanged, by
    cc -std=c99: the same prover ABI over HTTP to the proof server at
    ULTRAGROTH_SERVER (`server.py`).

The shim attaches to a running interpreter through PyGILState_Ensure, so a
Python process may load it with ctypes.CDLL and call it as a C consumer
would.
"""
from __future__ import annotations

import sysconfig
from pathlib import Path

from .runtime import configure as _configure_runtime

_configure_runtime()

from . import api  # noqa: E402
from . import native  # noqa: E402

SHIM_SOURCE = Path(__file__).resolve().parent / "csrc" / "capi_shim.cpp"
REMOTE_SOURCE = native.NATIVE_DIR / "ultragroth_remote.c"
INCLUDE_DIR = native.NATIVE_DIR / "include"


def _python_embed_flags() -> tuple:
    """(compile flags, link flags) of the running interpreter for an
    embedding library: native/Makefile's `python3-config --includes`,
    `--ldflags --embed` and -lpython<LDVERSION>."""
    paths = sysconfig.get_paths()
    inc = sorted({paths["include"], paths["platinclude"]})
    libdir = sysconfig.get_config_var("LIBDIR")
    ldver = sysconfig.get_config_var("LDVERSION")
    libs = (sysconfig.get_config_var("LIBS") or "").split()
    return ([f"-I{d}" for d in inc],
            [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ldver}",
             *libs])


def build_libraries() -> dict:
    """{"capi": path of libultragroth.so, "remote": path of
    libultragroth_remote.so}, each built once (RuntimeError with the
    compiler's output if a build fails)."""
    cflags, ldflags = _python_embed_flags()
    capi = native.build_library(
        "libultragroth.so",
        [native.compiler("g++", "c++"), *native.CXXFLAGS, *cflags],
        SHIM_SOURCE, tuple(ldflags))
    remote = native.build_library(
        "libultragroth_remote.so",
        [native.compiler("cc", "gcc"), "-O2", "-std=c99", "-fPIC", "-Wall"],
        REMOTE_SOURCE)
    return {"capi": capi, "remote": remote}


def groth16_prove(zkey: bytes, wtns: bytes):
    return api.groth16_prover(zkey, wtns)


def ultra_groth_prove(zkey: bytes, uwtns: bytes):
    return api.ultra_groth_prover(zkey, uwtns)


def groth16_public_size(zkey: bytes) -> int:
    return api.groth16_public_size_for_zkey_buf(zkey)


def ultra_groth_public_size(zkey: bytes) -> int:
    return api.ultra_groth_public_size_for_zkey_buf(zkey)


def groth16_verify(proof: str, inputs: str, vk: str) -> int:
    return api.groth16_verify(proof, inputs, vk)


def ultra_groth_verify(proof: str, inputs: str, vk: str) -> int:
    return api.ultra_groth_verify(proof, inputs, vk)


# -- handle API (create-once / prove-many; src/prover.h:80-163) --------------

def groth16_create(zkey: bytes):
    return api.Groth16Prover(zkey)


def ultra_groth_create(zkey: bytes):
    return api.UltraGrothProver(zkey)


def groth16_create_file(path: str):
    return api.Groth16Prover.from_file(path)


def ultra_groth_create_file(path: str):
    return api.UltraGrothProver.from_file(path)


def prover_prove(prover, wtns: bytes):
    """Shared by both handle types: -> (proof_json, public_json)."""
    return prover.prove(wtns)


def groth16_public_size_file(path: str) -> int:
    return api.groth16_public_size_for_zkey_file(path)


def ultra_groth_public_size_file(path: str) -> int:
    return api.ultra_groth_public_size_for_zkey_file(path)
