"""The iden3 binfile container (zkey, wtns, uwtns), written by the
benchmark itself: magic[4] | version u32 | sections u32 | (type u32,
size u64, payload)*."""
from __future__ import annotations

import struct

import numpy as np

from ..reference.curve import R

WTNS_MAGIC = b"wtns"
ZKEY_MAGIC = b"zkey"


def pack(magic: bytes, version: int, sections) -> bytes:
    out = [struct.pack("<4sII", magic, version, len(sections))]
    for stype, payload in sections:
        out.append(struct.pack("<IQ", stype, len(payload)))
        out.append(payload)
    return b"".join(out)


def u32(values) -> bytes:
    return np.ascontiguousarray(values, dtype="<u4").tobytes()


def wtns(values: np.ndarray, lookup: dict | None = None) -> bytes:
    """A .wtns (values [n, 16] uint16 standard form); with `lookup`
    (chunks, frequencies, wtns_indxs, push_indxs) the .uwtns sections 3-6."""
    n = values.shape[0]
    sections = [(1, struct.pack("<I", 32) + R.to_bytes(32, "little")
                 + struct.pack("<I", n)),
                (2, np.ascontiguousarray(values, dtype="<u2").tobytes())]
    if lookup is not None:
        for stype, key in enumerate(("chunks", "frequencies", "wtns_indxs",
                                     "push_indxs"), start=3):
            sections.append((stype, u32(lookup[key])))
    return pack(WTNS_MAGIC, 2, sections)


def sections(data: bytes) -> dict:
    """type -> payload bytes of a binfile (the first of each type)."""
    magic, version, n = struct.unpack_from("<4sII", data, 0)
    pos, out = 12, {}
    for _ in range(n):
        stype, size = struct.unpack_from("<IQ", data, pos)
        pos += 12
        out.setdefault(stype, data[pos:pos + size])
        pos += size
    return out


def read_wtns(data: bytes) -> tuple:
    """(values [n, 16] uint16, lookup dict or None) of a .wtns / .uwtns."""
    sec = sections(data)
    values = np.frombuffer(sec[2], dtype="<u2").reshape(-1, 16)
    if 3 not in sec:
        return values, None
    lookup = {key: np.frombuffer(sec[t], dtype="<u4")
              for t, key in enumerate(("chunks", "frequencies", "wtns_indxs",
                                       "push_indxs"), start=3)}
    return values, lookup
