"""UltraGroth's lookup circuit: K chunk signals range-checked against a
table of T entries by a log-derivative lookup (the Bionetta layout of
rarimo/ultragroth's src/README.md).

Signals: 0 one, 1 rand (public, the Fiat-Shamir challenge), 2 pub_x
(public), then K chunks (round 0), K inv1, T inv2 and T prod (final
round).  Constraints: (chunk_j + rand) inv1_j = 1; (i + rand) inv2_i =
1; freq_i inv2_i = prod_i; (sum inv1 - sum prod) * 1 = 0; pub_x * 1 =
pub_x.  The frequencies are constants of the circuit, so the chunk
multiset is the deployment's: it is drawn once from the key seed, and a
witness is a permutation of it (every witness satisfies the circuit).
Config keys: `log_domain`, `table_size`, `chunks`, `chunk_values`
({"dist": "uniform"}), `key_seed`."""
from __future__ import annotations

import numpy as np

from ..reference.curve import R
from ..reference.field import ints_to_u16
from . import Deployment, Witness
from .binfile import wtns


def chunk_multiset(config: dict) -> np.ndarray:
    t, k = int(config["table_size"]), int(config["chunks"])
    dist = config["chunk_values"]["dist"]
    if dist != "uniform":
        raise ValueError(f"lookup: chunk_values dist {dist!r}")
    gen = np.random.Generator(np.random.PCG64(int(config["key_seed"])))
    return gen.integers(0, t, k, dtype=np.int64).astype(np.uint32)


def build(config: dict) -> Deployment:
    t, k, log_n = (int(config["table_size"]), int(config["chunks"]),
                   int(config["log_domain"]))
    chunks = chunk_multiset(config)
    freq = np.bincount(chunks, minlength=t).astype(np.int64)
    n_rows = k + 2 * t + 2
    if n_rows > 1 << log_n:
        raise ValueError("lookup: constraints must fit the domain")
    v_chunk = 3 + np.arange(k)
    v_inv1 = 3 + k + np.arange(k)
    v_inv2 = 3 + 2 * k + np.arange(t)
    v_prod = 3 + 2 * k + t + np.arange(t)
    n_vars = 3 + 2 * k + 2 * t
    if (config.get("n_vars", n_vars), config.get("constraints", n_rows)) != (
            n_vars, n_rows):
        raise ValueError("lookup: n_vars must be 2K + 2T + 3, constraints "
                         "K + 2T + 2")
    ti, kj = np.arange(t), np.arange(k)
    one = lambda n: np.ones(n, np.int64)
    zero = lambda n: np.zeros(n, np.int64)
    # (m, c, s, value) blocks; value -1 stands for r - 1
    blocks = [
        (zero(k), kj, v_chunk, one(k)), (zero(k), kj, one(k), one(k)),
        (one(k), kj, v_inv1, one(k)),
        (zero(t), k + ti, zero(t), ti), (zero(t), k + ti, one(t), one(t)),
        (one(t), k + ti, v_inv2, one(t)),
        (zero(t), k + t + ti, zero(t), freq),
        (one(t), k + t + ti, v_inv2, one(t)),
        (zero(k), k + 2 * t + zero(k), v_inv1, one(k)),
        (zero(t), k + 2 * t + zero(t), v_prod, -one(t)),
        (one(1), k + 2 * t + zero(1), zero(1), one(1)),
        (zero(1), k + 2 * t + 1 + zero(1), 2 * one(1), one(1)),
        (one(1), k + 2 * t + 1 + zero(1), zero(1), one(1)),
    ]
    m, c, s, v = (np.concatenate([b[i] for b in blocks]) for i in range(4))
    coef_val = np.zeros((v.shape[0], 16), dtype=np.uint16)
    coef_val[:, 0] = v & 0xFFFF
    coef_val[:, 1] = (v >> 16) & 0xFFFF
    coef_val[v < 0] = ints_to_u16([R - 1])[0]
    final = np.concatenate([v_inv1, v_inv2, v_prod])
    return Deployment(
        protocol="ultragroth", n_vars=n_vars, n_public=2, log_n=log_n,
        coef_m=m.astype(np.uint32), coef_c=c.astype(np.uint32),
        coef_s=s.astype(np.uint32), coef_val=coef_val,
        sections={"a": ("g1", np.arange(n_vars)),
                  "b1": ("g1", np.arange(n_vars)),
                  "b2": ("g2", np.arange(n_vars)),
                  "rc": ("g1", v_chunk), "fc": ("g1", final),
                  "h": ("g1", None)},
        extra=dict(rand_indx=1, round_indexes=v_chunk, final_indexes=final,
                   table_size=t, chunks=chunks, frequencies=freq,
                   wtns_indxs=np.concatenate([[1], final]),
                   push_indxs=np.arange(1 + k + 2 * t)))


def witness(dep: Deployment, rng) -> Witness:
    """A permutation of the deployment's chunk multiset and a pub_x, both
    drawn from rng; the lookup signals are left zero (the prover fills
    them)."""
    ex = dep.extra
    gen = np.random.Generator(np.random.PCG64(rng.getrandbits(64)))
    chunks = gen.permutation(ex["chunks"])
    values = np.zeros((dep.n_vars, 16), dtype=np.uint16)
    values[0, 0] = 1
    values[2] = ints_to_u16([rng.randrange(R)])[0]
    values[3:3 + chunks.shape[0], 0] = chunks
    lookup = dict(chunks=chunks, frequencies=ex["frequencies"],
                  wtns_indxs=ex["wtns_indxs"], push_indxs=ex["push_indxs"])
    return Witness(values=values, data=wtns(values, lookup), lookup=lookup)
