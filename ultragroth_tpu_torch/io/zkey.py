"""zkey parsing: Groth16 (protocol 1) and UltraGroth (protocol 1337).

Section maps: src/zkey_utils.hpp:11-42 and
src/zkey_utils.cpp:42-163.  Point coordinates and coefficient values are
stored in Montgomery form (x*R mod p, R = 2^256), little-endian.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .binfile import BinFile, BinFileError
from .fieldenc import u32_view, words_to_int


class ZKeyError(ValueError):
    pass


def _read_u32(buf: np.ndarray, pos: int):
    return int(buf[pos:pos + 4].view("<u4")[0]), pos + 4


def _read_int(buf: np.ndarray, pos: int, nbytes: int):
    v = int.from_bytes(buf[pos:pos + nbytes].tobytes(), "little")
    return v, pos + nbytes


def _points_view(sec: np.ndarray, coords: int) -> np.ndarray:
    """Affine points section -> [N, coords, 8] u32 (Montgomery Fq words)."""
    words = u32_view(sec, 8)
    return words.reshape(-1, coords, 8)


def _parse_coefs(sec: np.ndarray):
    """Section 4: u32 count, then packed {m:u32,c:u32,s:u32,coef:32B} records.

    Returns (m, c, s, coef) arrays; coef is [n, 8] u32 Montgomery-form Fr.
    Parity: Coef struct at src/groth16.hpp:42-50, the +4 offset at
    src/groth16.cpp:38, and nCoefs = size/(12+n8r) at src/zkey_utils.cpp:73.
    """
    n = sec.size // 44
    body = sec[4:4 + n * 44]
    rec = body.reshape(n, 44)
    m = rec[:, 0:4].copy().view("<u4").reshape(n)
    cc = rec[:, 4:8].copy().view("<u4").reshape(n)
    s = rec[:, 8:12].copy().view("<u4").reshape(n)
    coef = rec[:, 12:44].copy().view("<u4").reshape(n, 8)
    return m, cc, s, coef


@dataclass
class Groth16ZKey:
    n_vars: int
    n_public: int
    domain_size: int
    n_coefs: int
    q_prime: int
    r_prime: int
    # vk points: [coords, 8] u32 Montgomery
    alpha1: np.ndarray
    beta1: np.ndarray
    beta2: np.ndarray
    gamma2: np.ndarray
    delta1: np.ndarray
    delta2: np.ndarray
    # coefficient triples + values
    coef_m: np.ndarray
    coef_c: np.ndarray
    coef_s: np.ndarray
    coef_val: np.ndarray      # [nCoefs, 8] Montgomery Fr
    # bases
    ic: np.ndarray            # [nPublic+1, 2, 8]
    points_a: np.ndarray      # [nVars, 2, 8]
    points_b1: np.ndarray     # [nVars, 2, 8]
    points_b2: np.ndarray     # [nVars, 4, 8]
    points_c: np.ndarray      # [nVars - nPublic - 1, 2, 8]
    points_h: np.ndarray      # [domainSize, 2, 8]


@dataclass
class UltraGrothZKey:
    n_vars: int
    n_public: int
    domain_size: int
    n_coefs: int
    q_prime: int
    r_prime: int
    num_indexes_c1: int
    num_indexes_c2: int
    rand_indx: int
    alpha1: np.ndarray
    beta1: np.ndarray
    beta2: np.ndarray
    gamma2: np.ndarray
    round_delta1: np.ndarray
    round_delta2: np.ndarray
    final_delta1: np.ndarray
    final_delta2: np.ndarray
    coef_m: np.ndarray
    coef_c: np.ndarray
    coef_s: np.ndarray
    coef_val: np.ndarray
    ic: np.ndarray
    points_a: np.ndarray
    points_b1: np.ndarray
    points_b2: np.ndarray
    round_points_c: np.ndarray   # section 8
    final_points_c: np.ndarray   # section 9
    round_indexes: np.ndarray    # section 10, u32
    final_indexes: np.ndarray    # section 11, u32
    points_h: np.ndarray         # section 12


def _protocol_id(bf: BinFile) -> int:
    sec1 = bf.section(C.ZKEY_SEC_HEADER)
    return int(sec1[0:4].view("<u4")[0])


def _parse_groth_header(bf: BinFile):
    sec = bf.section(C.ZKEY_SEC_GROTH_HEADER)
    pos = 0
    n8q, pos = _read_u32(sec, pos)
    q_prime, pos = _read_int(sec, pos, n8q)
    n8r, pos = _read_u32(sec, pos)
    r_prime, pos = _read_int(sec, pos, n8r)
    n_vars, pos = _read_u32(sec, pos)
    n_public, pos = _read_u32(sec, pos)
    domain_size, pos = _read_u32(sec, pos)
    return sec, pos, n8q, q_prime, n8r, r_prime, n_vars, n_public, domain_size


def _vk_point(sec: np.ndarray, pos: int, coords: int, n8q: int):
    p = u32_view(sec[pos:pos + coords * n8q], 8).reshape(coords, 8)
    return p, pos + coords * n8q


def parse_groth16_zkey(data) -> Groth16ZKey:
    bf = data if isinstance(data, BinFile) else BinFile.parse(data, C.ZKEY_MAGIC, 1)
    if _protocol_id(bf) != C.GROTH16_PROTOCOL_ID:
        raise ZKeyError("zkey file is not groth16")
    sec, pos, n8q, q_prime, n8r, r_prime, n_vars, n_public, domain_size = _parse_groth_header(bf)
    alpha1, pos = _vk_point(sec, pos, 2, n8q)
    beta1, pos = _vk_point(sec, pos, 2, n8q)
    beta2, pos = _vk_point(sec, pos, 4, n8q)
    gamma2, pos = _vk_point(sec, pos, 4, n8q)
    delta1, pos = _vk_point(sec, pos, 2, n8q)
    delta2, pos = _vk_point(sec, pos, 4, n8q)

    m, cc, s, coef = _parse_coefs(bf.section(C.ZKEY_SEC_COEFS))
    return Groth16ZKey(
        n_vars=n_vars, n_public=n_public, domain_size=domain_size,
        n_coefs=len(m), q_prime=q_prime, r_prime=r_prime,
        alpha1=alpha1, beta1=beta1, beta2=beta2, gamma2=gamma2,
        delta1=delta1, delta2=delta2,
        coef_m=m, coef_c=cc, coef_s=s, coef_val=coef,
        ic=_points_view(bf.section(C.ZKEY_SEC_IC), 2),
        points_a=_points_view(bf.section(C.ZKEY_SEC_POINTS_A), 2),
        points_b1=_points_view(bf.section(C.ZKEY_SEC_POINTS_B1), 2),
        points_b2=_points_view(bf.section(C.ZKEY_SEC_POINTS_B2), 4),
        points_c=_points_view(bf.section(C.ZKEY_SEC_POINTS_C), 2),
        points_h=_points_view(bf.section(C.ZKEY_SEC_POINTS_H), 2),
    )


def parse_ultragroth_zkey(data) -> UltraGrothZKey:
    bf = data if isinstance(data, BinFile) else BinFile.parse(data, C.ZKEY_MAGIC, 1)
    if _protocol_id(bf) != C.ULTRAGROTH_PROTOCOL_ID:
        raise ZKeyError("zkey file is not ultragroth")
    sec, pos, n8q, q_prime, n8r, r_prime, n_vars, n_public, domain_size = _parse_groth_header(bf)
    num_indexes_c1, pos = _read_u32(sec, pos)
    num_indexes_c2, pos = _read_u32(sec, pos)
    rand_indx, pos = _read_u32(sec, pos)
    alpha1, pos = _vk_point(sec, pos, 2, n8q)
    beta1, pos = _vk_point(sec, pos, 2, n8q)
    beta2, pos = _vk_point(sec, pos, 4, n8q)
    gamma2, pos = _vk_point(sec, pos, 4, n8q)
    round_delta1, pos = _vk_point(sec, pos, 2, n8q)
    round_delta2, pos = _vk_point(sec, pos, 4, n8q)
    final_delta1, pos = _vk_point(sec, pos, 2, n8q)
    final_delta2, pos = _vk_point(sec, pos, 4, n8q)

    m, cc, s, coef = _parse_coefs(bf.section(C.ZKEY_SEC_COEFS))
    return UltraGrothZKey(
        n_vars=n_vars, n_public=n_public, domain_size=domain_size,
        n_coefs=len(m), q_prime=q_prime, r_prime=r_prime,
        num_indexes_c1=num_indexes_c1, num_indexes_c2=num_indexes_c2,
        rand_indx=rand_indx,
        alpha1=alpha1, beta1=beta1, beta2=beta2, gamma2=gamma2,
        round_delta1=round_delta1, round_delta2=round_delta2,
        final_delta1=final_delta1, final_delta2=final_delta2,
        coef_m=m, coef_c=cc, coef_s=s, coef_val=coef,
        ic=_points_view(bf.section(C.ZKEY_SEC_IC), 2),
        points_a=_points_view(bf.section(C.ZKEY_SEC_POINTS_A), 2),
        points_b1=_points_view(bf.section(C.ZKEY_SEC_POINTS_B1), 2),
        points_b2=_points_view(bf.section(C.ZKEY_SEC_POINTS_B2), 4),
        round_points_c=_points_view(bf.section(C.UG_SEC_ROUND_POINTS_C), 2),
        final_points_c=_points_view(bf.section(C.UG_SEC_FINAL_POINTS_C), 2),
        round_indexes=bf.section(C.UG_SEC_ROUND_INDEXES).copy().view("<u4"),
        final_indexes=bf.section(C.UG_SEC_FINAL_INDEXES).copy().view("<u4"),
        points_h=_points_view(bf.section(C.UG_SEC_POINTS_H), 2),
    )
