"""The repeated-squaring chain x_{i+1} = x_i^2 (Groth16): one constraint
a squaring, signals [1, x_n (public), x_0, ..., x_{n-1}].  Its A and B
rows each hold one signal with coefficient 1; C = A * B is not stored in
a zkey.  Config keys: `constraints`, `log_domain`."""
from __future__ import annotations

import numpy as np

from ..reference.curve import R
from ..reference.field import ints_to_u16
from . import Deployment, Witness
from .binfile import wtns


def build(config: dict) -> Deployment:
    n_c, log_n = int(config["constraints"]), int(config["log_domain"])
    if not 0 < n_c <= 1 << log_n:
        raise ValueError("square_chain: constraints must fit the domain")
    n_vars, n_public = n_c + 2, 1
    if config.get("n_vars", n_vars) != n_vars:
        raise ValueError("square_chain: n_vars must be constraints + 2")
    rows = np.arange(n_c, dtype=np.uint32)
    coef_val = np.zeros((2 * n_c, 16), dtype=np.uint16)
    coef_val[:, 0] = 1
    return Deployment(
        protocol="groth16", n_vars=n_vars, n_public=n_public, log_n=log_n,
        coef_m=np.tile(np.array([0, 1], np.uint32), n_c),
        coef_c=np.repeat(rows, 2), coef_s=np.repeat(rows + 2, 2),
        coef_val=coef_val,
        sections={"a": ("g1", np.arange(n_vars)),
                  "b1": ("g1", np.arange(n_vars)),
                  "b2": ("g2", np.arange(n_vars)),
                  "c": ("g1", np.arange(n_public + 1, n_vars)),
                  "h": ("g1", None)})


def witness(dep: Deployment, rng) -> Witness:
    """x_0 drawn from rng, full width."""
    n_c = dep.n_vars - 2
    x = rng.randrange(2, R)
    chain = [x]
    for _ in range(n_c):
        x = x * x % R
        chain.append(x)
    values = ints_to_u16([1, chain[-1]] + chain[:n_c])
    return Witness(values=values, data=wtns(values))
