"""Circuits the benchmark proves: each kind is a module of this package,
named by a configuration's `circuit` key, with

  build(config) -> Deployment      the constraint system as the key holds it
  witness(dep, rng) -> Witness     one satisfying witness drawn from rng

A new kind is a new module here; nothing else names the kinds."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Deployment:
    """What the key is made from and the reference works from.

    coef_*: the R1CS coefficient records of the key's section 4 (matrix m
    0 = A, 1 = B; constraint c; signal s) with their values as standard
    ints in `coef_val` [n, 16] uint16 limbs.  sections: MSM point set name
    -> (group, the witness indices its scalars are, in point order);
    the H set is over the domain, not the witness."""
    protocol: str                    # "groth16" | "ultragroth"
    n_vars: int
    n_public: int
    log_n: int
    coef_m: np.ndarray
    coef_c: np.ndarray
    coef_s: np.ndarray
    coef_val: np.ndarray
    sections: dict
    extra: dict = field(default_factory=dict)

    @property
    def domain(self) -> int:
        return 1 << self.log_n

    def at_infinity(self, name: str):
        """Bool [n] of the points of set `name` a setup makes infinity, or
        None: the A (B1, B2) point of a signal in no A (B) row is
        [A_i(tau)] = [0].  The C and H sets of these circuits have none."""
        matrix = {"a": 0, "b1": 1, "b2": 1}.get(name)
        if matrix is None:
            return None
        used = np.zeros(self.n_vars, dtype=bool)
        used[self.coef_s[self.coef_m == matrix]] = True
        return ~used[self.sections[name][1]]


@dataclass
class Witness:
    """values [n_vars, 16] uint16 standard-form limbs; the file's bytes;
    lookup: the .uwtns lookup sections (UltraGroth) or None."""
    values: np.ndarray
    data: bytes
    lookup: dict | None = None


def kind(name: str):
    """The module of circuit kind `name`."""
    if not name.isidentifier():
        raise ValueError(f"circuit kind {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
