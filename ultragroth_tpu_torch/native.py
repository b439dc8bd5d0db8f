"""ctypes bindings of the native host runtime (`native/ultragroth_io.cpp`,
unchanged): the twin of the JAX package's `native.py`.

The library is built with g++ at first use into the port's build
directory (`runtime.compile_cache_dir()`, `build_library`), never into the
JAX package's `_native/`.  Every entry point returns None when the library
cannot be had (no compiler, no source in this checkout): `available()` says
which, and the callers keep their Python paths, the plain versions the
tests hold the native ones against:

  * `keccak256`: the UltraGroth challenge (`keccak.py`);
  * `words_to_planes`: the threaded wire-word -> limb-plane repack of a
    large key or witness loaded on the CPU (`ops/limbs.py`), here into the
    port's [8, N] 32-bit planes;
  * `binfile_scan`: the iden3 section scan (the walk of
    `io/binfile.py:BinFile.parse`);
  * `load_file`: a read-only mapping of a file.

As in the JAX package, only the first two have callers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
IO_SOURCE = NATIVE_DIR / "ultragroth_io.cpp"
# native/Makefile's CXXFLAGS without -march=native: the build directory
# may move with its checkout to another machine
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall"]

_lock = threading.Lock()
_LIB = None
_TRIED = False


class _Section(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("offset", ctypes.c_uint64),
                ("size", ctypes.c_uint64)]


def compiler(*names: str) -> str:
    """The first of `names` on PATH, else RuntimeError."""
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no compiler: none of {names} on PATH")


def build_library(lib_name: str, cmd: list, source: Path,
                  link: tuple = ()) -> Path:
    """Compile `source` once into `<build dir>/native-<hash>/<lib_name>`
    by `cmd` (the compiler and its flags) -shared -o <lib> <source> <link>.
    The hash covers the command and the source, so a changed one rebuilds.
    Returns the library's path; RuntimeError with the compiler's output if
    the build fails."""
    from .runtime import compile_cache_dir
    h = hashlib.sha256(" ".join([*cmd, *link]).encode() + source.read_bytes())
    out = compile_cache_dir() / f"native-{h.hexdigest()[:16]}" / lib_name
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{lib_name}.tmp{os.getpid()}")
    proc = subprocess.run([*cmd, "-shared", "-o", str(tmp), str(source),
                           *link], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {lib_name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = build_library("libultragroth_io.so",
                               [compiler("g++", "c++"), *CXXFLAGS],
                               IO_SOURCE, ("-lpthread",))
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError):
            return None
        lib.ug_load_file.restype = ctypes.c_void_p
        lib.ug_load_file.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.ug_unload_file.restype = None
        lib.ug_unload_file.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ug_binfile_scan.restype = ctypes.c_int64
        lib.ug_binfile_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(_Section),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)]
        lib.ug_words_to_planes.restype = None
        lib.ug_words_to_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_int]
        lib.ug_keccak256.restype = None
        lib.ug_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_char_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def keccak256(data: bytes) -> bytes | None:
    """Native Keccak-256 or None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.ug_keccak256(bytes(data), len(data), out)
    return out.raw


def words_to_planes(words: np.ndarray) -> np.ndarray | None:
    """[N, 8] u32 wire words -> the port's [8, N] u32 limb planes, or None
    without the library.  The native shuffle (threaded) writes the JAX
    package's [16, N] 16-bit planes; their halves are joined here."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n, n_words = words.shape
    halves = np.empty((2 * n_words, n), dtype=np.uint32)
    lib.ug_words_to_planes(
        words.ctypes.data_as(ctypes.c_void_p), n, n_words,
        halves.ctypes.data_as(ctypes.c_void_p), os.cpu_count() or 1)
    return halves[0::2] | (halves[1::2] << np.uint32(16))


def binfile_scan(data: np.ndarray):
    """-> (version, [(type, offset, size)]) or None without the library;
    ValueError for a truncated container."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    max_sections = 64
    sections = (_Section * max_sections)()
    version = ctypes.c_uint32(0)
    n = lib.ug_binfile_scan(
        data.ctypes.data_as(ctypes.c_void_p), data.size, sections,
        max_sections, ctypes.byref(version))
    if n < 0:
        raise ValueError("invalid binfile")
    return version.value, [(sections[i].type, sections[i].offset,
                            sections[i].size)
                           for i in range(min(n, max_sections))]


def load_file(path) -> np.ndarray | None:
    """The file mapped read-only (`ug_load_file`) as a uint8 array, or None
    without the library; OSError if it cannot be mapped.  The mapping is
    released when the array and every view of it are gone."""
    lib = _load()
    if lib is None:
        return None
    size = ctypes.c_uint64(0)
    ptr = lib.ug_load_file(os.fsencode(path), ctypes.byref(size))
    if not ptr:
        raise OSError(f"cannot map {path}")
    buf = (ctypes.c_uint8 * size.value).from_address(ptr)
    weakref.finalize(buf, lib.ug_unload_file, ptr, size.value)
    out = np.frombuffer(buf, dtype=np.uint8)
    out.flags.writeable = False          # the pages are mapped read-only
    return out
