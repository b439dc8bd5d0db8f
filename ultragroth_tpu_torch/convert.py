"""Carry state between the JAX package's layout and the port's.

The JAX package holds field elements as 16 limbs of 16 bits in u32 planes
[16, *batch]; the port as 8 limbs of 32 bits, [8, *batch] (`ops/limbs.py`).
Both are plain bit shuffles of the same integers.  The JAX package keeps
its point sets plane-major (x and y as planes over the points); the port's
MSMs read point-major tables [N, 2, *elem] (`ops/curve.py:
table_from_planes`).  `prover_state_from_jax` turns the JAX provers' numpy
state (what their `g1_section_to_planes` / `g2_section_to_planes` give,
plus the coefficient and index arrays) into the tensors
`TorchGroth16Prover` and `TorchUltraGrothProver` keep, so both packages can
compute on one key.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.curve import table_from_planes
from .ops.limbs import limb_dtype, narrow


def planes16_to_planes8(p16) -> np.ndarray:
    """[16, ...] u32 planes of 16-bit limbs -> [8, ...] of 32-bit limbs."""
    p16 = np.asarray(p16, dtype=np.uint32)
    return (p16[0::2] | (p16[1::2] << np.uint32(16))).astype(np.uint32)


def planes8_to_planes16(p8) -> np.ndarray:
    """[8, ...] u32 planes of 32-bit limbs -> [16, ...] of 16-bit limbs."""
    p8 = np.asarray(p8, dtype=np.uint32)
    out = np.empty((16,) + p8.shape[1:], dtype=np.uint32)
    out[0::2] = p8 & np.uint32(0xFFFF)
    out[1::2] = p8 >> np.uint32(16)
    return out


def to_torch(p16, device="cpu") -> torch.Tensor:
    """JAX-layout planes [16, ...] -> port tensor [8, ...] on `device`."""
    t = torch.from_numpy(planes16_to_planes8(p16).astype(np.int64)).to(device)
    return narrow(t, limb_dtype(device))


def from_torch(t: torch.Tensor) -> np.ndarray:
    """Port tensor [8, ...] -> JAX-layout planes [16, ...] (numpy)."""
    return planes8_to_planes16(t.cpu().numpy().astype(np.uint32))


def g1_points_from_jax(x, y, inf, device="cpu"):
    """JAX (x [16, N], y [16, N], inf [N]) -> port (table [N, 2, 8], inf)."""
    return (table_from_planes(torch.stack([to_torch(x, device),
                                           to_torch(y, device)])),
            torch.from_numpy(np.asarray(inf, dtype=bool)).to(device))


def g2_points_from_jax(x, y, inf, device="cpu"):
    """JAX ((x0, x1), (y0, y1), inf) -> port (table [N, 2, 2, 8], inf)."""
    pair = lambda c: torch.stack([to_torch(c[0], device),
                                  to_torch(c[1], device)])
    return (table_from_planes(torch.stack([pair(x), pair(y)])),
            torch.from_numpy(np.asarray(inf, dtype=bool)).to(device))


def fixed_table_from_jax(packed, inf, device="cpu"):
    """The JAX package's fixed-base table (`ops/msm.py:msm_fixed_table`:
    packed [K * 16, W * Npad], rows x then y, each coordinate component
    16 planes; K = 2 for G1, 4 for G2) and its inf [Npad] -> the port's
    (table [W * Npad, 2, 8] or [W * Npad, 2, 2, 8], inf)."""
    p = np.asarray(packed, dtype=np.uint32)
    comps = [to_torch(p[16 * k:16 * (k + 1)], device)
             for k in range(p.shape[0] // 16)]
    if len(comps) == 2:
        planes = torch.stack(comps)
    else:
        planes = torch.stack([torch.stack(comps[:2]), torch.stack(comps[2:])])
    return (table_from_planes(planes),
            torch.from_numpy(np.asarray(inf, dtype=bool)).to(device))


G1_SECTIONS = ("points_a", "points_b1", "points_c", "points_h",
               "round_points_c", "final_points_c")
INT_ARRAYS = ("coef_m", "coef_c", "coef_s", "round_indexes", "final_indexes")


def prover_state_from_jax(state: dict, device="cpu") -> dict:
    """The JAX prover's state -> the port prover's tensors.

    state: any of the G1 sections (points_a, points_b1, points_h, and
    points_c for Groth16 or round_points_c, final_points_c for UltraGroth)
    as (x, y, inf); points_b2 as ((x0, x1), (y0, y1), inf); coef_val_mont
    [16, nCoefs]; the int arrays coef_m, coef_c, coef_s and, for
    UltraGroth, round_indexes, final_indexes (numpy or anything np.asarray
    takes).  Returns the same keys in the layout of the port's provers."""
    out = {}
    for k, v in state.items():
        if k in G1_SECTIONS:
            out[k] = g1_points_from_jax(*v, device=device)
        elif k == "points_b2":
            out[k] = g2_points_from_jax(*v, device=device)
        elif k == "coef_val_mont":
            out[k] = to_torch(v, device)
        elif k in INT_ARRAYS:
            out[k] = torch.from_numpy(np.asarray(v, np.int64)).to(device)
        else:
            raise KeyError(f"prover_state_from_jax: unknown key {k!r}")
    return out
