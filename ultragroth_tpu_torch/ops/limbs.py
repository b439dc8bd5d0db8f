"""Limb layout of the port: 8 little-endian 32-bit limbs, plane-major.

A batch of field elements is a tensor [8, *batch]: limb j of every element
sits in one contiguous plane, so a kernel thread per lane reads each limb
with neighbouring threads on neighbouring addresses.  The zkey/wtns wire
word [N, 8] (u32, little-endian) is the same value layout transposed, so
splitting a witness into limbs is one transpose on the device.

Storage dtype depends on the device (`limb_dtype`):
  * CUDA: int32 holding the u32 bit pattern — what the kernels take;
  * CPU:  int64 holding values in [0, 2^32) — CPU torch has no u32 add,
    shift or compare, so the plain versions compute in int64.
`widen` / `narrow` convert at the boundary; the plain field ops accept
either and answer in the dtype they were given.
"""
from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 32
NLIMBS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1


def limb_dtype(device) -> torch.dtype:
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def widen(x: torch.Tensor) -> torch.Tensor:
    """Limb tensor -> int64 with limb values in [0, 2^32)."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & LIMB_MASK


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 limbs in [0, 2^32) -> `dtype` (int32 keeps the u32 bits)."""
    if dtype == torch.int64:
        return x
    return (x - ((x >> 31) << 32)).to(dtype)


def int_to_limbs(v: int, nlimbs: int = NLIMBS) -> list:
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)]


def ints_to_words(values) -> np.ndarray:
    """Iterable of ints in [0, 2^256) -> [N, 8] u32 wire words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, NLIMBS).copy()


NATIVE_MIN_ROWS = 1 << 14
"""From this many rows a [N, 8] repack on the CPU takes the native
runtime's threaded shuffle (`native.words_to_planes`), as in the JAX
package's `ops/limbs.py`."""


def words_to_tensor(words: np.ndarray, device="cpu") -> torch.Tensor:
    """Wire words [..., 8] u32 -> the same layout on `device`, in the
    device's limb dtype."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if torch.device(device).type == "cuda":
        # a witness parsed in place from read-only bytes is copied once:
        # torch.from_numpy takes writable arrays only
        words = np.require(words, requirements="W")
        return torch.from_numpy(words.view(np.int32)).to(device)
    return torch.from_numpy(words.astype(np.int64))


def words_to_planes(words: np.ndarray, device="cpu") -> torch.Tensor:
    """Wire words [..., 8] u32 -> limb planes [8, ...] on `device`.

    Uploads the compact u32 form and moves the limb axis on the device
    (the twin of the JAX package's `words_to_planes_device`); on the CPU a
    [N, 8] array of NATIVE_MIN_ROWS rows or more is repacked by the native
    runtime where it is available."""
    if (torch.device(device).type == "cpu" and words.ndim == 2
            and words.shape[0] >= NATIVE_MIN_ROWS):
        from .. import native
        planes = native.words_to_planes(words)
        if planes is not None:
            return torch.from_numpy(planes.astype(np.int64))
    return words_to_tensor(words, device).movedim(-1, 0).contiguous()


def ints_to_planes(values, device="cpu") -> torch.Tensor:
    """Iterable of ints -> [8, N] limb planes."""
    return words_to_planes(ints_to_words(values), device)


def planes_to_words(planes: torch.Tensor) -> np.ndarray:
    """[8, ...] limb planes -> [..., 8] u32 wire words (host)."""
    return widen(planes).movedim(0, -1).cpu().numpy().astype(np.uint32)


def planes_to_ints(planes: torch.Tensor) -> list:
    """[8, *batch] limb planes -> flat list of ints."""
    w = planes_to_words(planes).reshape(-1, NLIMBS)
    raw = w.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(w.shape[0])]
