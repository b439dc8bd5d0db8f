"""wtns / uwtns witness files.

.wtns v2 (parity: src/wtns_utils.cpp:13-26):
  section 1: n8:u32, prime:n8 bytes LE, nVars:u32
  section 2: nVars * 32B little-endian Fr values, STANDARD form.

.uwtns reuses the container with extra u32-array sections 3..6
(parity: src/prover.cpp:287-292, semantics in src/README.md):
  3: chunks   4: frequencies   5: wtns_indxs   6: push_indxs
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .binfile import BinFile, write_binfile, pack_binfile
from .fieldenc import u32_view, ints_to_array


class WtnsError(ValueError):
    pass


@dataclass
class Witness:
    n8: int
    prime: int
    n_vars: int
    values: np.ndarray       # [nVars, 8] u32, standard form
    # uwtns extras (None for plain wtns)
    chunks: np.ndarray | None = None
    frequencies: np.ndarray | None = None
    wtns_indxs: np.ndarray | None = None
    push_indxs: np.ndarray | None = None


def parse_wtns(data) -> Witness:
    bf = data if isinstance(data, BinFile) else BinFile.parse(data, C.WTNS_MAGIC, 2)
    sec1 = bf.section(1)
    n8 = int(sec1[0:4].view("<u4")[0])
    prime = int.from_bytes(sec1[4:4 + n8].tobytes(), "little")
    n_vars = int(sec1[4 + n8:8 + n8].view("<u4")[0])
    values = u32_view(bf.section(2), n8 // 4)

    def _u32sec(stype):
        if not bf.has_section(stype):
            return None
        return bf.section(stype).copy().view("<u4")

    return Witness(
        n8=n8, prime=prime, n_vars=n_vars, values=values,
        chunks=_u32sec(C.UWTNS_SEC_CHUNKS),
        frequencies=_u32sec(C.UWTNS_SEC_FREQUENCIES),
        wtns_indxs=_u32sec(C.UWTNS_SEC_WTNS_INDEXES),
        push_indxs=_u32sec(C.UWTNS_SEC_PUSH_INDEXES),
    )


def _wtns_sections(values, prime: int, extras=None):
    values = np.ascontiguousarray(np.asarray(values, dtype=np.uint32))
    n_vars = values.shape[0]
    sec1 = struct.pack("<I", 32) + prime.to_bytes(32, "little") + struct.pack("<I", n_vars)
    sections = [(1, sec1), (2, values.tobytes())]
    if extras:
        for stype, arr in extras:
            sections.append((stype, np.asarray(arr, dtype=np.uint32).tobytes()))
    return sections


def write_wtns(path, values, prime: int = C.FR_MODULUS) -> None:
    """values: [nVars, 8] u32 standard-form Fr (or list of ints)."""
    if not isinstance(values, np.ndarray):
        values = ints_to_array(values)
    write_binfile(path, C.WTNS_MAGIC, 2, _wtns_sections(values, prime))


def pack_wtns(values, prime: int = C.FR_MODULUS) -> bytes:
    if not isinstance(values, np.ndarray):
        values = ints_to_array(values)
    return pack_binfile(C.WTNS_MAGIC, 2, _wtns_sections(values, prime))


def write_uwtns(path, values, chunks, frequencies, wtns_indxs, push_indxs,
                prime: int = C.FR_MODULUS) -> None:
    if not isinstance(values, np.ndarray):
        values = ints_to_array(values)
    extras = [
        (C.UWTNS_SEC_CHUNKS, chunks),
        (C.UWTNS_SEC_FREQUENCIES, frequencies),
        (C.UWTNS_SEC_WTNS_INDEXES, wtns_indxs),
        (C.UWTNS_SEC_PUSH_INDEXES, push_indxs),
    ]
    write_binfile(path, C.WTNS_MAGIC, 2, _wtns_sections(values, prime, extras))


def pack_uwtns(values, chunks, frequencies, wtns_indxs, push_indxs,
               prime: int = C.FR_MODULUS) -> bytes:
    if not isinstance(values, np.ndarray):
        values = ints_to_array(values)
    extras = [
        (C.UWTNS_SEC_CHUNKS, chunks),
        (C.UWTNS_SEC_FREQUENCIES, frequencies),
        (C.UWTNS_SEC_WTNS_INDEXES, wtns_indxs),
        (C.UWTNS_SEC_PUSH_INDEXES, push_indxs),
    ]
    return pack_binfile(C.WTNS_MAGIC, 2, _wtns_sections(values, prime, extras))
