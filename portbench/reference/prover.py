"""The plain reference prover: what each proof must be, worked out from the
key's known logs.

Every point the benchmark's key holds is k G with k known (`keygen`), or
infinity, so an MSM over a point set is (sum_i k_i s_i) G over its finite
points: one scalar product mod r,
here in plain PyTorch limbs (`field`).  The quotient's scalars are worked
out again (`quotient`), the UltraGroth challenge and lookup signals too
(`keccak`, Python integers).  The blinding is the protocol's, on logs; the
proof's points are then single scalar multiples of the generators
(`curve.mul`).  Nothing here reads what the program under test made.

Groth16 (rapidsnark's prover): A = a + alpha + r delta, B = b2 + beta + s
delta, C = c + h + s A + r (b1 + beta + s delta) - r s delta.  UltraGroth
(rarimo/ultragroth): D = rc + r0 delta_f, challenge keccak(D) mod r, the
lookup signals scattered into the witness, then Groth16's with delta_f and
C -= r0 delta_r.

`scalar_bits` below 254 makes this the control: every MSM scalar is cut
to its low `scalar_bits` bits before its scalar product, as a prover that
kept one 32-bit limb fewer would do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import curve as ec
from .curve import R
from .field import BITS, Field, limb_sum_to_int
from .keccak import keccak256
from .quotient import Domain, quotient, scatter

ROW = 1024


@dataclass
class Derived:
    """What one prove's scalars are: MSM set name -> scalars [16, k]
    (standard form; zero where the set's point is infinity), and their
    logs' sums."""
    scalars: dict
    sums: dict
    publics: list
    extra: dict


class ReferenceProver:
    def __init__(self, dep, logs, device="cpu", scalar_bits: int = 254):
        self.dep, self.logs = dep, logs
        self.F = Field(R, device)
        self.dom = Domain(self.F, dep.log_n)
        self.scalar_bits = scalar_bits
        dev = self.F.device
        self.coef_m = torch.from_numpy(dep.coef_m.astype(np.int64)).to(dev)
        self.coef_c = torch.from_numpy(dep.coef_c.astype(np.int64)).to(dev)
        self.coef_s = torch.from_numpy(dep.coef_s.astype(np.int64)).to(dev)
        self.coef_mont = self.F.to_mont(self.F.from_u16(dep.coef_val))
        self.inf = {name: None if dep.at_infinity(name) is None
                    else torch.from_numpy(dep.at_infinity(name)).to(dev)
                    for name in dep.sections}
        self.index = {name: None if idx is None
                      else torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
                      for name, (_, idx) in dep.sections.items()}

    # -- scalar products -----------------------------------------------------

    def _cut(self, s: torch.Tensor) -> torch.Tensor:
        if self.scalar_bits >= 254:
            return s
        full, rest = divmod(self.scalar_bits, BITS)
        s = s.clone()
        if rest:
            s[full] &= (1 << rest) - 1
            full += 1
        s[full:] = 0
        return s

    def _finite(self, name: str, s: torch.Tensor) -> torch.Tensor:
        """Scalars of set `name` with those of its points at infinity
        zeroed: such a point adds nothing."""
        inf = self.inf[name]
        return s if inf is None else s.masked_fill(inf, 0)

    def log_sum(self, name: str, s: torch.Tensor) -> int:
        """sum_i k_i s_i mod r over set `name`, k_i = o + a m^2 + b j^2."""
        o, a, b = self.logs.sections[name]
        s = self._cut(s)
        i = torch.arange(s.shape[1], device=s.device)
        m, j = i // ROW, i % ROW
        if s.shape[1] > 1 << 21:
            raise ValueError("log_sum: int64 column sums need n <= 2^21")
        t0 = limb_sum_to_int(s.sum(1).tolist())
        ta = limb_sum_to_int((s * (m * m)).sum(1).tolist())
        tb = limb_sum_to_int((s * (j * j)).sum(1).tolist())
        return (o * t0 + a * ta + b * tb) % R

    def _final_round(self, w: torch.Tensor, c_name: str) -> tuple:
        a, b = scatter(self.F, w, self.coef_m, self.coef_c, self.coef_s,
                       self.coef_mont, self.dep.domain)
        h = quotient(self.F, self.dom, a, b)
        scalars = {n: self._finite(n, w if self.index[n] is None
                                   else w[:, self.index[n]])
                   for n in ("a", "b1", "b2", c_name)}
        scalars["h"] = h
        return scalars

    # -- Groth16 -------------------------------------------------------------

    def groth16_derive(self, values: np.ndarray) -> Derived:
        w = self.F.from_u16(values)
        scalars = self._final_round(w, "c")
        sums = {n: self.log_sum(n, s) for n, s in scalars.items()}
        publics = [str(v) for v in
                   self.F.to_ints(w[:, 1:self.dep.n_public + 1])]
        return Derived(scalars, sums, publics, {})

    def groth16_proof(self, d: Derived, r: int, s: int) -> dict:
        k, x = d.sums, self.logs.scalars
        pa = (k["a"] + x["alpha"] + r * x["delta"]) % R
        pb = (k["b2"] + x["beta"] + s * x["delta"]) % R
        pb1 = (k["b1"] + x["beta"] + s * x["delta"]) % R
        pc = (k["c"] + k["h"] + s * pa + r * pb1 - r * s * x["delta"]) % R
        return {"pi_a": ec.to_json(ec.mul(ec.G1, pa)),
                "pi_b": ec.to_json(ec.mul(ec.G2, pb), g2=True),
                "pi_c": ec.to_json(ec.mul(ec.G1, pc)),
                "protocol": "groth16"}

    # -- UltraGroth ----------------------------------------------------------

    def ultragroth_derive(self, values: np.ndarray, lookup: dict,
                          r0: int) -> Derived:
        F, ex, x = self.F, self.dep.extra, self.logs.scalars
        w = F.from_u16(values)
        rc = w[:, self.index["rc"]]
        d_log = (self.log_sum("rc", rc) + r0 * x["delta_f"]) % R
        d = ec.mul(ec.G1, d_log)
        buf = (b"\0" * 64 if d is None
               else d[0].to_bytes(32, "big") + d[1].to_bytes(32, "big"))
        rand = int.from_bytes(keccak256(buf), "big") % R
        t = ex["table_size"]
        inv2 = _inverses([(i + rand) % R for i in range(t)])
        freq = np.asarray(lookup["frequencies"], np.int64)
        prod = [int(f) * v % R for f, v in zip(freq, inv2)]
        inv2_t = F.tensor(inv2)
        chunks = torch.from_numpy(np.asarray(lookup["chunks"],
                                             np.int64)).to(F.device)
        push = torch.cat([F.tensor([rand]), inv2_t[:, chunks], inv2_t,
                          F.tensor(prod)], dim=1)
        w = w.clone()
        to = torch.from_numpy(np.asarray(lookup["wtns_indxs"], np.int64))
        src = torch.from_numpy(np.asarray(lookup["push_indxs"], np.int64))
        w[:, to.to(F.device)] = push[:, src.to(F.device)]
        scalars = self._final_round(w, "fc")
        scalars["rc"] = rc
        sums = {n: self.log_sum(n, s) for n, s in scalars.items()}
        sums["rc"] = d_log
        pub = [i for i in range(1, self.dep.n_public + 1)
               if i != ex["rand_indx"]]
        publics = [str(v) for v in F.to_ints(w[:, pub])]
        return Derived(scalars, sums, publics, {"d": d})

    def ultragroth_proof(self, d: Derived, r0: int, r: int, s: int) -> dict:
        k, x = d.sums, self.logs.scalars
        pa = (k["a"] + x["alpha"] + r * x["delta_f"]) % R
        pb = (k["b2"] + x["beta"] + s * x["delta_f"]) % R
        pb1 = (k["b1"] + x["beta"] + s * x["delta_f"]) % R
        pc = (k["fc"] + k["h"] + s * pa + r * pb1 - r * s * x["delta_f"]
              - r0 * x["delta_r"]) % R
        return {"pi_a": ec.to_json(ec.mul(ec.G1, pa)),
                "pi_b": ec.to_json(ec.mul(ec.G2, pb), g2=True),
                "pi_f": ec.to_json(ec.mul(ec.G1, pc)),
                "pi_r": ec.to_json(d.extra["d"]),
                "protocol": "ultragroth"}

    # -- one prove -----------------------------------------------------------

    def expected(self, values, lookup, blind: dict, cache: dict | None = None,
                 key=None) -> tuple[dict, list, Derived]:
        """(proof dict, public signals, Derived) of one prove; Groth16's
        Derived is kept in `cache` under `key` (it depends on the witness
        alone)."""
        if self.dep.protocol == "groth16":
            if cache is not None and key in cache:
                d = cache[key]
            else:
                d = self.groth16_derive(values)
                if cache is not None:
                    cache[key] = d
            return self.groth16_proof(d, blind["r"], blind["s"]), d.publics, d
        d = self.ultragroth_derive(values, lookup, blind["r0"])
        return (self.ultragroth_proof(d, blind["r0"], blind["r"], blind["s"]),
                d.publics, d)


def _inverses(xs: list) -> list:
    """Inverses mod r by Montgomery's trick; 0 -> 0."""
    pre, acc = [], 1
    for v in xs:
        pre.append(acc)
        acc = acc * (v or 1) % R
    acc = pow(acc, -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        v = xs[i] or 1
        out[i] = acc * pre[i] % R if xs[i] else 0
        acc = acc * v % R
    return out
