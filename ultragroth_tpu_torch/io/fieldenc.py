"""Host-side encodings of BN254 field elements.

Canonical host layout: little-endian u32 words, shape [..., 8] (256 bits),
bit-identical to the 32-byte wire encoding used by zkey/wtns files.  Whether
a given array is in Montgomery or standard form is a property of its source
(zkey points/coefs: Montgomery; wtns values: standard), tracked by the
callers — exactly the discipline the reference uses.
"""
from __future__ import annotations

import numpy as np

from ..constants import FQ_MODULUS, FR_MODULUS, FQ_R_INV, FR_R_INV


def u32_view(raw: np.ndarray, elem_words: int = 8) -> np.ndarray:
    """View a uint8 buffer as [..., elem_words] little-endian uint32."""
    arr = raw.view(np.dtype("<u4"))
    return arr.reshape(-1, elem_words)


def words_to_int(words) -> int:
    """One [8] u32 row -> Python int."""
    v = 0
    for i, w in enumerate(words):
        v |= int(w) << (32 * i)
    return v


def int_to_words(v: int, n_words: int = 8) -> np.ndarray:
    out = np.zeros(n_words, dtype=np.uint32)
    for i in range(n_words):
        out[i] = (v >> (32 * i)) & 0xFFFFFFFF
    return out


def ints_to_array(values, n_words: int = 8) -> np.ndarray:
    out = np.zeros((len(values), n_words), dtype=np.uint32)
    for j, v in enumerate(values):
        v = int(v)
        for i in range(n_words):
            out[j, i] = (v >> (32 * i)) & 0xFFFFFFFF
    return out


def array_to_ints(arr: np.ndarray) -> list:
    """[N, 8] u32 -> list of ints (vectorized via object dtype)."""
    arr = np.asarray(arr, dtype=np.uint64)
    acc = np.zeros(arr.shape[:-1], dtype=object)
    for i in range(arr.shape[-1] - 1, -1, -1):
        acc = acc * (1 << 32) + arr[..., i].astype(object)
    return list(acc.reshape(-1))


def mont_decode_fq(v: int) -> int:
    return (v * FQ_R_INV) % FQ_MODULUS


def mont_decode_fr(v: int) -> int:
    return (v * FR_R_INV) % FR_MODULUS
