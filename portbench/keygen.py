"""The benchmark's own proving keys: zkey bytes whose every point has a
known discrete log, so the reference can work out each MSM as one scalar
product.

Point i of an MSM set is k_i G with k_i = o + a m^2 + b j^2 (i = 1024 m +
j), o, a, b drawn from the configuration's key seed, except where a
ceremony key has infinity (`Deployment.at_infinity`: the A and B points
of signals absent from A or B), which the prover's MSMs skip.  Quadratic logs keep
a bucket's partial sums off the next point's log, as a ceremony key's
random logs do; logs affine in i would make the prover's incomplete
additions meet P == +-Q.  The set is built as U_m + V_j from two short
tables (Python integers), every sum in one batch on the device
(`reference.field`), the result in Montgomery form, which is the zkey's
encoding.  The verifying-key points alpha, beta, gamma, delta (UltraGroth:
delta_round, delta_final) are multiples of the generators by logs from the
same seed; IC is never read by a prover and holds known multiples too.

Keys are cached under the benchmark's `_cache/keys/`, named by a hash of
the configuration file: a deployment's key is fixed, its witnesses vary.
"""
from __future__ import annotations

import hashlib
import os
import random
import struct
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .circuits import Deployment
from .circuits.binfile import ZKEY_MAGIC, pack, u32
from .reference import curve as ec
from .reference.curve import Q, R
from .reference.field import LIMBS, Field

GROTH16_ID, ULTRAGROTH_ID = 1, 1337
ROW = 1024          # i = ROW * m + j
BLOCK = 1 << 20     # points a device batch


@dataclass
class KeyLogs:
    sections: dict      # name -> (o, a, b)
    scalars: dict       # alpha, beta, gamma, delta | delta_r, delta_f, ic


def key_logs(dep: Deployment, key_seed: int) -> KeyLogs:
    rng = random.Random(key_seed)
    names = (("alpha", "beta", "gamma", "delta") if dep.protocol == "groth16"
             else ("alpha", "beta", "gamma", "delta_r", "delta_f"))
    scalars = {n: rng.randrange(1, R) for n in names}
    scalars["ic"] = [rng.randrange(1, R) for _ in range(dep.n_public + 1)]
    sections = {name: (rng.randrange(1, R), rng.randrange(1, 1 << 128),
                       rng.randrange(1, 1 << 128))
                for name in dep.sections}
    return KeyLogs(sections=sections, scalars=scalars)


def known_log(spec, i: int) -> int:
    o, a, b = spec
    m, j = divmod(i, ROW)
    return (o + a * m * m + b * j * j) % R


# -- points ---------------------------------------------------------------

def _mont_words(v: int) -> bytes:
    return (v * (1 << 256) % Q).to_bytes(32, "little")


def encode(point) -> bytes:
    """An affine point as the zkey writes it (Montgomery Fq words; G2 as
    x0, x1, y0, y1; infinity as zeros)."""
    if point is None:
        return b"\0" * 64
    if isinstance(point[0], tuple):
        return b"".join(_mont_words(v) for v in (*point[0], *point[1]))
    return _mont_words(point[0]) + _mont_words(point[1])


def _quad_table(gen, c0: int, c2: int, count: int) -> list:
    """(c0 + c2 t^2) G for t < count, by second differences."""
    F = ec.field_of(gen)
    out, cur = [], ec.mul(gen, c0)
    diff, step2 = ec.mul(gen, c2), ec.mul(gen, 2 * c2)
    for _ in range(count):
        out.append(cur)
        cur = ec.affine_add(F, cur, diff)
        diff = ec.affine_add(F, diff, step2)
    return out


class _Fq2:
    """Fq2 on pairs of limb tensors over `Field` F (u^2 = -1)."""

    def __init__(self, F: Field):
        self.F = F

    def add(self, a, b):
        return (self.F.add(a[0], b[0]), self.F.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.F.sub(a[0], b[0]), self.F.sub(a[1], b[1]))

    def mul(self, a, b):
        F = self.F
        return (F.sub(F.mul(a[0], b[0]), F.mul(a[1], b[1])),
                F.add(F.mul(a[0], b[1]), F.mul(a[1], b[0])))

    def batch_inv(self, a):
        F = self.F
        n = F.batch_inv_mont(F.add(F.mul(a[0], a[0]), F.mul(a[1], a[1])))
        return (F.mul(a[0], n), F.neg(F.mul(a[1], n)))


class _Fq1:
    def __init__(self, F: Field):
        self.F = F
        self.add, self.sub, self.mul = F.add, F.sub, F.mul

    def batch_inv(self, a):
        return self.F.batch_inv_mont(a)


def _coords(F: Field, pts: list, g2: bool):
    """Affine points -> (x, y) Montgomery limb tensors (G2: pairs)."""
    mont = lambda vs: F.tensor([v * (1 << 256) % Q for v in vs])
    if g2:
        return ((mont([p[0][0] for p in pts]), mont([p[0][1] for p in pts])),
                (mont([p[1][0] for p in pts]), mont([p[1][1] for p in pts])))
    return mont([p[0] for p in pts]), mont([p[1] for p in pts])


def _take(v, idx):
    return tuple(t[:, idx] for t in v) if isinstance(v, tuple) else v[:, idx]


def _where(mask, a, b):
    if isinstance(a, tuple):
        return tuple(torch.where(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask, a, b)


def section_points(F: Field, group: str, spec, n: int) -> np.ndarray:
    """k_i G for i < n as zkey words: [n, 2 or 4, 16] uint16."""
    g2 = group == "g2"
    gen = ec.G2 if g2 else ec.G1
    o, a, b = spec
    rows = -(-n // ROW)
    us = _quad_table(gen, o, a, rows)
    vs = _quad_table(gen, 0, b, ROW)          # V_0 is infinity: unused
    ux, uy = _coords(F, us, g2)
    vx, vy = _coords(F, [vs[1]] + vs[1:], g2)
    A = _Fq2(F) if g2 else _Fq1(F)
    out = []
    for start in range(0, n, BLOCK):
        i = torch.arange(start, min(n, start + BLOCK), device=F.device)
        m, j = i // ROW, i % ROW
        x1, y1, x2, y2 = (_take(ux, m), _take(uy, m), _take(vx, j),
                          _take(vy, j))
        first = (j == 0).unsqueeze(0)
        one = F.const(F.r_mod, 1).expand(LIMBS, i.shape[0])
        dx = A.sub(x2, x1)
        dx = _where(first, (one, torch.zeros_like(one)) if g2 else one, dx)
        lam = A.mul(A.sub(y2, y1), A.batch_inv(dx))
        x3 = A.sub(A.sub(A.mul(lam, lam), x1), x2)
        y3 = A.sub(A.mul(lam, A.sub(x1, x3)), y1)
        x3, y3 = _where(first, x1, x3), _where(first, y1, y3)
        parts = (list(x3) + list(y3)) if g2 else [x3, y3]
        out.append(np.stack([F.to_u16(t) for t in parts], axis=1))
    return np.concatenate(out)


# -- the zkey ---------------------------------------------------------------

def _coefs_section(F: Field, dep: Deployment) -> bytes:
    """Section 4: a u32 count, then {m, c, s: u32, value: 32-byte
    Montgomery Fr} records."""
    n = dep.coef_m.shape[0]
    vals = np.empty((n, 16), dtype=np.uint16)
    for start in range(0, n, BLOCK):
        v = F.from_u16(dep.coef_val[start:start + BLOCK])
        vals[start:start + BLOCK] = F.to_u16(F.to_mont(v))
    rec = np.empty((n, 22), dtype="<u2")
    rec[:, 0:6] = np.stack([dep.coef_m, dep.coef_c, dep.coef_s],
                           axis=1).astype("<u4").view("<u2")
    rec[:, 6:] = vals
    return struct.pack("<I", n) + rec.tobytes()


def zkey_bytes(dep: Deployment, logs: KeyLogs, device) -> bytes:
    """The deployment's zkey (Groth16: protocol 1; UltraGroth: 1337)."""
    Fq_ = Field(Q, device)
    Fr_ = Field(R, device)
    sc = logs.scalars
    g1 = lambda k: encode(ec.mul(ec.G1, k))
    g2 = lambda k: encode(ec.mul(ec.G2, k))
    head = (struct.pack("<I", 32) + Q.to_bytes(32, "little")
            + struct.pack("<I", 32) + R.to_bytes(32, "little")
            + struct.pack("<III", dep.n_vars, dep.n_public, dep.domain))
    pts = {}
    for name, (group, idx) in dep.sections.items():
        p = section_points(Fq_, group, logs.sections[name],
                           dep.domain if idx is None else len(idx))
        inf = dep.at_infinity(name)
        if inf is not None:
            p[inf] = 0                      # infinity: all-zero words
        pts[name] = p.tobytes()
    ic = b"".join(g1(k) for k in sc["ic"])
    if dep.protocol == "groth16":
        head += (g1(sc["alpha"]) + g1(sc["beta"]) + g2(sc["beta"])
                 + g2(sc["gamma"]) + g1(sc["delta"]) + g2(sc["delta"]))
        sections = [(1, struct.pack("<I", GROTH16_ID)), (2, head), (3, ic),
                    (4, _coefs_section(Fr_, dep)), (5, pts["a"]),
                    (6, pts["b1"]), (7, pts["b2"]), (8, pts["c"]),
                    (9, pts["h"])]
    else:
        ex = dep.extra
        head += struct.pack("<III", len(ex["round_indexes"]),
                            len(ex["final_indexes"]), ex["rand_indx"])
        head += (g1(sc["alpha"]) + g1(sc["beta"]) + g2(sc["beta"])
                 + g2(sc["gamma"]) + g1(sc["delta_r"]) + g2(sc["delta_r"])
                 + g1(sc["delta_f"]) + g2(sc["delta_f"]))
        ic = b"".join(g1(k) for k in sc["ic"][:dep.n_public])
        sections = [(1, struct.pack("<I", ULTRAGROTH_ID)), (2, head), (3, ic),
                    (4, _coefs_section(Fr_, dep)), (5, pts["a"]),
                    (6, pts["b1"]), (7, pts["b2"]), (8, pts["rc"]),
                    (9, pts["fc"]), (10, u32(ex["round_indexes"])),
                    (11, u32(ex["final_indexes"])), (12, pts["h"])]
    return pack(ZKEY_MAGIC, 1, sections)


def cached_zkey(cache_dir: Path, config_path: Path, dep: Deployment,
                logs: KeyLogs, device) -> tuple[bytes, float]:
    """The deployment's zkey bytes from the cache, built there first if
    missing.  Returns (bytes, seconds spent building; 0 when cached)."""
    digest = hashlib.sha256(config_path.read_bytes()).hexdigest()[:16]
    path = cache_dir / f"{config_path.stem}-{digest}.zkey"
    built = 0.0
    if not path.exists():
        t0 = time.perf_counter()
        data = zkey_bytes(dep, logs, device)
        cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part")
        tmp.write_bytes(data)
        os.replace(tmp, path)
        built = time.perf_counter() - t0
    return path.read_bytes(), built
