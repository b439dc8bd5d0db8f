"""Builds of the port's CUDA sources with text changes, one ctypes library
each: the shared part of the tools that time a kernel's design choices
apart (tools/torch_drain_variants.py, tools/torch_ntt_variants.py).

A variant is a copy of `ultragroth_tpu_torch/csrc/` with some (file, text,
replacement) changes made, compiled with the port's nvcc flags (cios
build); every nvcc of a tool starts together.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def patched_csrc(tmp, name, changes, extra_files=None):
    """A copy of csrc/ as tmp/name with each (file, text, replacement) of
    `changes` made (the text must occur exactly once) and the files of
    `extra_files` ({file name: text}) added; returns its path."""
    from ultragroth_tpu_torch.ops import _build
    d = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, d)
    for fname, text in (extra_files or {}).items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    for fname, old, new in changes:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {fname} does not hold the text to "
                               f"change exactly once: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return d


def build(jobs, meanwhile=None):
    """jobs {key: (library path, source, extra nvcc flags)} -> {key:
    (ctypes library, nvcc's report)}, every nvcc started together;
    `meanwhile()`, if given, runs while they compile."""
    from ultragroth_tpu_torch.ops import _build
    procs = {}
    for key, (so, src, extra) in jobs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", so, src]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    if meanwhile is not None:
        meanwhile()
    out = {}
    for key, (so, proc) in procs.items():
        report = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{report}")
        out[key] = (ctypes.CDLL(so, mode=os.RTLD_LOCAL), report)
    return out


def bind(lib, *symbols):
    """Types lib's launchers as the port's (`_build._SIGNATURES`, int
    result); returns lib."""
    from ultragroth_tpu_torch.ops import _build
    for sym in symbols:
        getattr(lib, sym).argtypes = _build._SIGNATURES[sym]
        getattr(lib, sym).restype = ctypes.c_int
    return lib


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them, and the
    torch version."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return f"{smi} | torch {torch.__version__}"
