"""Process-level configuration shared by the port's entry points (api, cli,
server): the twin of the JAX package's `runtime.py`.

- ULTRAGROTH_PLATFORM=cpu|cuda picks the device the entry points prove on
  (`default_device()`, default cuda).  With cuda and no card it raises:
  no entry point carries on on the CPU unless the caller asked for it.
- ULTRAGROTH_COMPILE_CACHE=<dir> is where the CUDA kernel libraries are
  built (`compile_cache_dir()`, default `ultragroth_tpu_torch/_build/`);
  the JAX package's variable of the same name holds its XLA cache.  `off`
  means no persistent cache, as it does there: the libraries are built
  into a temporary directory of the process, removed when it exits.
- ULTRAGROTH_COORDINATOR (with ULTRAGROTH_NUM_PROCESSES and
  ULTRAGROTH_PROCESS_ID) forms the multi-process runtime: `configure()`
  calls `parallel.mesh.distributed_init()`, which starts a
  `torch.distributed` process group (NCCL on cuda, gloo on the CPU), as
  the JAX package's `configure()` starts `jax.distributed`.

The JAX package's `ensure_map_count` (a raise of vm.max_map_count for
XLA:CPU's JIT) has no twin: the port compiles no XLA program, and its code
writes nothing outside its checkout and build directory.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

import torch

PLATFORMS = ("cpu", "cuda")
DEFAULT_CACHE = Path(__file__).resolve().parent / "_build"

_CONFIGURED = False
_PROCESS_CACHE: Path | None = None


def platform() -> str:
    plat = os.environ.get("ULTRAGROTH_PLATFORM", "") or "cuda"
    if plat not in PLATFORMS:
        raise ValueError(f"ULTRAGROTH_PLATFORM={plat!r}: expected one of "
                         f"{PLATFORMS}")
    return plat


def default_device() -> torch.device:
    """The device the entry points use (ULTRAGROTH_PLATFORM)."""
    plat = platform()
    if plat == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set ULTRAGROTH_PLATFORM=cpu to "
                           "prove on the CPU")
    return torch.device(plat)


def compile_cache_dir() -> Path:
    cache = os.environ.get("ULTRAGROTH_COMPILE_CACHE", "")
    if cache == "off":
        return _process_cache()
    return Path(cache) if cache else DEFAULT_CACHE


def _process_cache() -> Path:
    """The process's own build directory (ULTRAGROTH_COMPILE_CACHE=off),
    made at first use and removed at exit."""
    global _PROCESS_CACHE
    if _PROCESS_CACHE is None:
        _PROCESS_CACHE = Path(tempfile.mkdtemp(prefix="ultragroth_kernels_"))
        atexit.register(shutil.rmtree, _PROCESS_CACHE, ignore_errors=True)
    return _PROCESS_CACHE


def configure() -> None:
    """Once per process, before the first prover: check the platform and
    form the multi-process runtime (a no-op unless ULTRAGROTH_COORDINATOR
    is set)."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    platform()
    from .parallel.mesh import distributed_init
    distributed_init()
    _CONFIGURED = True
