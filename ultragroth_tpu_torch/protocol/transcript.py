"""Shared protocol-level helpers: domains, roots of unity, JSON shapes."""
from __future__ import annotations

import json

from ..constants import FR_MODULUS, FR_ROOT_OF_UNITY, FR_TWO_ADICITY


def root_of_unity(log2_n: int) -> int:
    """Primitive 2^log2_n-th root of unity in Fr (ffjavascript/ffiasm table)."""
    if log2_n > FR_TWO_ADICITY:
        raise ValueError(f"domain 2^{log2_n} exceeds Fr 2-adicity")
    w = FR_ROOT_OF_UNITY
    for _ in range(FR_TWO_ADICITY - log2_n):
        w = (w * w) % FR_MODULUS
    return w


def g1_to_json(p) -> list:
    """Affine G1 -> snarkjs projective-ish JSON triple (decimal strings)."""
    if p is None:
        return ["0", "1", "0"]
    return [str(p[0]), str(p[1]), "1"]


def g2_to_json(p) -> list:
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (xa, xb), (ya, yb) = p
    return [[str(xa), str(xb)], [str(ya), str(yb)], ["1", "0"]]


def g1_from_json(v):
    x, y = int(v[0]), int(v[1])
    if len(v) > 2 and int(v[2]) == 0:
        return None
    return (x, y)


def g2_from_json(v):
    if len(v) > 2 and int(v[2][0]) == 0 and int(v[2][1]) == 0:
        return None
    return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))
