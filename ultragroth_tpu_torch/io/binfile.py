"""iden3 binfile container: parser + writer.

Wire format (parity with src/binfile_utils.cpp:32-80):
  magic[4] | version:u32 | nSections:u32 | (type:u32, size:u64, payload)*

Sections of the same type may repeat; accessors take (type, pos).  Parsing is
zero-copy: sections are numpy views into one mmap/bytes buffer.
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<4sII")
_SECTION = struct.Struct("<IQ")


class BinFileError(ValueError):
    pass


@dataclass
class BinFile:
    magic: bytes
    version: int
    sections: dict = field(default_factory=dict)  # type -> [np.uint8 view]

    @classmethod
    def parse(cls, data, expected_magic: bytes | None = None, max_version: int | None = None) -> "BinFile":
        buf = np.frombuffer(data, dtype=np.uint8)
        if buf.size < 12:
            raise BinFileError("File is too short.")
        magic, version, n_sections = _HEADER.unpack_from(data, 0)
        if expected_magic is not None and magic != expected_magic:
            raise BinFileError(
                f"Invalid file type. It should be {expected_magic!r} and it is {magic!r}")
        if max_version is not None and version > max_version:
            raise BinFileError(
                f"Invalid version. It should be <={max_version} and it is {version}")
        pos = 12
        sections: dict = {}
        for i in range(n_sections):
            if pos + 12 > buf.size:
                raise BinFileError(f"Section #{i} is invalid.")
            stype, ssize = _SECTION.unpack_from(data, pos)
            pos += 12
            if pos + ssize > buf.size:
                raise BinFileError(f"Section #{i} is invalid.")
            sections.setdefault(stype, []).append(buf[pos:pos + ssize])
            pos += ssize
        return cls(magic=magic, version=version, sections=sections)

    @classmethod
    def load(cls, path, expected_magic: bytes | None = None, max_version: int | None = None) -> "BinFile":
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return cls.parse(mm, expected_magic, max_version)

    def section(self, stype: int, pos: int = 0) -> np.ndarray:
        if stype not in self.sections:
            raise BinFileError(f"Section does not exist: {stype}")
        lst = self.sections[stype]
        if pos >= len(lst):
            raise BinFileError(f"Section pos too big: {pos}")
        return lst[pos]

    def section_size(self, stype: int, pos: int = 0) -> int:
        return int(self.section(stype, pos).size)

    def has_section(self, stype: int) -> bool:
        return stype in self.sections


def write_binfile(path, magic: bytes, version: int, sections) -> None:
    """sections: iterable of (type:int, payload:bytes-like), written in order."""
    with open(path, "wb") as f:
        f.write(_HEADER.pack(magic, version, len(sections)))
        for stype, payload in sections:
            payload = bytes(payload)
            f.write(_SECTION.pack(stype, len(payload)))
            f.write(payload)


def pack_binfile(magic: bytes, version: int, sections) -> bytes:
    out = bytearray(_HEADER.pack(magic, version, len(sections)))
    for stype, payload in sections:
        payload = bytes(payload)
        out += _SECTION.pack(stype, len(payload))
        out += payload
    return bytes(out)
