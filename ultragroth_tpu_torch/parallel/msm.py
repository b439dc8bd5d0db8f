"""Data-parallel MSM over a device mesh: the twin of the JAX package's
`parallel/msm.py`.

The points are padded to a power of two (infinity points, zero scalars,
as `_pad_pow2` pads them) and cut into one block a shard, each block
resident on its shard's device in the port's point-major [N/D, 2, *elem]
layout (`shard_points`, once a key).  A sharded MSM cuts the scalars the
same way, runs the port's whole single-device MSM (`ops.msm.msm`: drain,
reduction, combine) on every shard at the caller's window c, gathers the
D partial xyzz points and folds them in pairs with `curve_add_where`
(`_fold_gathered`, the JAX package's `_fold_pairs` levels): log2(D)
launches.  The cross-shard traffic is D points.

Every scalar must be canonical (< r): each shard's MSM checks its block
and raises otherwise (`ops/msm.py:_split_factor` would drop points).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import kernels
from ..ops import msm as _msm
from ..ops.limbs import limb_dtype
from .mesh import Mesh, Shards, gather, on_device, shards, to_device


@dataclass
class ShardedPoints:
    """One point set cut over the shards of a mesh: `tables[i]` [rows, 2,
    *elem] and `infs[i]` [rows] on `sh.devices[i]`; `size` = rows * count,
    the padded N; `n` the points before the pad."""
    group: str
    sh: Shards
    tables: list
    infs: list
    size: int
    n: int

    @property
    def rows(self) -> int:
        return self.size // self.sh.count


def padded_size(n: int, count: int) -> int:
    """N padded as the JAX package's `_pad_pow2` pads it (a power of two,
    at least 64), and to at least one row a shard."""
    return max(64, 1 << max(n - 1, 0).bit_length(), count)


def shard_points(group: str, table: torch.Tensor, inf: torch.Tensor,
                 mesh: Mesh, axis="data") -> ShardedPoints:
    """Cut a point-major table [N, 2, *elem] and its infinity mask [N]
    over `mesh[axis]`: shard g holds rows g*N'/D .. (g+1)*N'/D of the
    padded set, the pad at infinity, on its own device."""
    sh = shards(mesh, axis)
    n = table.shape[0]
    size = padded_size(n, sh.count)
    rows = size // sh.count
    tables, infs = [], []
    for i, dev in enumerate(sh.devices):
        lo = (sh.first + i) * rows
        k = max(0, min(rows, n - lo))
        t = torch.zeros((rows,) + tuple(table.shape[1:]),
                        dtype=limb_dtype(dev), device=dev)
        m = torch.ones(rows, dtype=torch.bool, device=dev)
        if k:
            t[:k] = to_device(table[lo:lo + k], dev)
            m[:k] = inf[lo:lo + k].to(dev)
        tables.append(t)
        infs.append(m)
    return ShardedPoints(group, sh, tables, infs, size, n)


def _fold_gathered(group: str, pts: torch.Tensor) -> torch.Tensor:
    """Sum D gathered xyzz points (`pts` [4, *elem, D], D a power of two)
    in pairs: lane i = pts[2i] + pts[2i+1], log2(D) `curve_add_where`
    launches -> one point [4, *elem]."""
    d = pts.shape[-1]
    assert d & (d - 1) == 0, d
    while pts.shape[-1] > 1:
        pts = kernels.curve_add_where(group, pts[..., 0::2].contiguous(),
                                      pts[..., 1::2].contiguous())
    return pts[..., 0]


@torch.inference_mode()
def msm_sharded(points: ShardedPoints, scalars: torch.Tensor,
                c: int) -> torch.Tensor:
    """sum_i scalars[i] * P_i as ONE xyzz point [4, *elem] on the scalars'
    device.  scalars: [8, n] standard-form Fr planes, each < r (checked
    shard by shard); c: the window the caller picked for the whole N."""
    sh, rows = points.sh, points.rows
    n = scalars.shape[-1]
    if scalars.shape != (8, points.n):
        raise ValueError(f"msm_sharded: {points.n} points, scalars "
                         f"{tuple(scalars.shape)}")
    partials = []
    for i, dev in enumerate(sh.devices):
        lo = (sh.first + i) * rows
        k = max(0, min(rows, n - lo))
        with on_device(dev):
            s = torch.zeros((8, rows), dtype=limb_dtype(dev), device=dev)
            if k:
                s[:, :k] = to_device(scalars[:, lo:lo + k], dev)
            partials.append(_msm.msm(points.group, points.tables[i],
                                     points.infs[i], s, c))
    comm = sh.devices[0]
    gathered = gather(sh, partials, comm)            # [D, 4, *elem]
    with on_device(comm):
        out = _fold_gathered(points.group, gathered.movedim(0, -1)
                             .contiguous())
    return to_device(out, scalars.device)


def msm_g1_sharded(table, inf, scalars, mesh: Mesh, axis="data",
                   c: int = 16):
    """G1 MSM sharded across `mesh[axis]` (a name or a tuple of names):
    table [N, 2, 8] point-major Montgomery affine, inf [N], scalars [8, N]
    standard-form Fr.  A prover shards its tables once (`shard_points`)
    and calls `msm_sharded`."""
    return msm_sharded(shard_points("g1", table, inf, mesh, axis), scalars,
                       c)


def msm_g2_sharded(table, inf, scalars, mesh: Mesh, axis="data",
                   c: int = 16):
    """G2 twin of `msm_g1_sharded`: table [N, 2, 2, 8]."""
    return msm_sharded(shard_points("g2", table, inf, mesh, axis), scalars,
                       c)
