"""PyTorch port: the MSM's bucket reduction and window combine
(`curve_bucket_reduce`, `curve_window_combine`, csrc/reduce.cuh).

The plain versions against the chain of `curve_add_where` /
`curve_horner_scale` launches the MSM ran before them (kept here as
`_old_reduce` / `_old_combine`, over the plain versions of those kernels),
bit for bit on the xyzz coordinates; against the oracle and the JAX
package's `curve_horner_scale` + fold after to_affine (the JAX package's
`_weighted_totals` compiles for ~20 s on the CPU, so that comparison is
`slow`); and the kernels' bodies built for the host with g++ (both field
builds), their launch sequence driven as the wrappers drive it, against
the plain versions bit for bit.  Cases: buckets at infinity, equal
buckets (the doubling branch), P with -P, and split groups of sub-lanes.
"""
import ctypes
import functools
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import kernels as jk
from ultragroth_tpu.ops import msm as jm
from ultragroth_tpu.ops.curve import g1_ops as jg1_ops, g2_ops as jg2_ops
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import curve_ops
from ultragroth_tpu_torch.oracle import curve as oc

from tests.test_torch_field import (REPO, affine_points, g1_table, g2_table,
                                    random_points, sample, xyzz_from_jax,
                                    xyzz_to_jax)
from tests.test_torch_kernels import _Args


def _elem(group):
    return () if group == "g1" else (2,)


def _points(group, n, seed):
    """n distinct xyzz points [4, *elem, 8, n] with ZZ != 1: 16 random
    points doubled, the rest sums of earlier ones."""
    ops = curve_ops(group)
    base = random_points(group, 16, seed)
    tab, _ = (g1_table if group == "g1" else g2_table)(base)
    pts = ops.dbl(ops.affine_to_xyzz(tab[0], tab[1],
                                     torch.zeros(16, dtype=torch.bool)))
    while pts.shape[-1] < n:
        pts = torch.cat([pts, ops.add_unified(pts, torch.roll(pts, 3, -1))],
                        -1)
    return pts[..., :n]


def _buckets(group, w, m, seed):
    """Bucket sums [4, *elem, w, m] with the reduction's special cases:
    window 0 lane 0 at infinity and lanes 2, 3 equal (the first level
    doubles); window 1 lanes 4, 5 = P, -P (the fold meets infinity);
    window 2 lanes 2, 3 = lanes 0, 1 (the second level doubles) and its
    last two lanes at infinity."""
    ops = curve_ops(group)
    acc = _points(group, w * m, seed).reshape(4, *_elem(group), 8, w, m)
    acc = acc.clone()
    acc[..., 0, 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 0, 3] = acc[..., 0, 2]
    acc[..., 1, 5] = ops.neg(acc[..., 1, 4:5])[..., 0]
    if w > 2:
        acc[..., 2, 2:4] = acc[..., 2, 0:2]
        acc[..., 2, m - 2:] = ops.inf_xyzz((2,))
    return acc.contiguous()


def _old_reduce(group, acc, splits):
    """The MSM's reduction before the reduce kernel: per split group the
    pre-folds, then `_weighted_totals` (pending banks concatenated onto
    the current sums, every level one batch of adds), all through
    curve_add_where_plain."""
    ops = curve_ops(group)
    add = lambda a, b: K.curve_add_where_plain(group, a, b)
    fold = lambda x: add(x[..., 0::2], x[..., 1::2])
    groups = {}
    for w, s in enumerate(splits):
        groups.setdefault(s, []).append(w)
    wsums = [None] * len(splits)
    for split, ws in groups.items():
        g = acc[..., torch.tensor(ws), :]
        for _ in range(split.bit_length() - 1):
            g = fold(g)
        wg, cur, pend, u = len(ws), g, [], acc.shape[-1] // split
        while u > 1:
            ev_neg = ops.neg(cur[..., 0::2])
            folded = fold(torch.cat([cur] + pend, dim=-2))
            cur = folded[..., :wg, :]
            pend = [folded[..., (i + 1) * wg:(i + 2) * wg, :]
                    for i in range(len(pend))]
            pend.append(ev_neg)
            u //= 2
        total = cur[..., 0]
        for lvl in reversed(pend):
            total = add(add(total, total), lvl[..., 0])
        for i, w in enumerate(ws):
            wsums[w] = total[..., i]
    return torch.stack(wsums, dim=-1)


def _old_combine(group, pts, c):
    """curve_horner_scale, then the padded pairwise fold."""
    ops = curve_ops(group)
    w = pts.shape[-1]
    m = 1 << max(1, (w - 1).bit_length())
    total = torch.cat([K.curve_horner_scale_plain(group, pts, c),
                       ops.inf_xyzz((m - w,))], -1)
    while m > 1:
        total = K.curve_add_where_plain(group, total[..., 0::2],
                                        total[..., 1::2])
        m //= 2
    return total[..., 0]


def _windows(group, c, w, seed):
    """Window sums [4, *elem, 8, w] whose fold meets its special cases:
    S_0 = 2^c S_1 (the first pair doubles), 2^(2c) S_2 = -2^(3c) S_3 (the
    second pair is infinity), S_4 at infinity."""
    ops = curve_ops(group)
    pts = _points(group, w, seed).clone()
    d = pts[..., 1:2]
    for _ in range(c):
        d = ops.dbl(d)
    pts[..., 0] = d[..., 0]
    d = pts[..., 3:4]
    for _ in range(c):
        d = ops.dbl(d)
    pts[..., 2] = ops.neg(d)[..., 0]
    pts[..., 4] = ops.inf_xyzz((1,))[..., 0]
    return pts.contiguous()


def _oracle_weighted(group, acc, splits):
    """sum_i (i+1) B_i per window, B_i the sum of bucket i's sub-lanes."""
    add = oc.g1_add if group == "g1" else oc.g2_add
    mul = oc.g1_mul if group == "g1" else oc.g2_mul
    w, m = acc.shape[-2:]
    out = []
    for k in range(w):
        lanes = affine_points(group, acc[..., k, :])
        s, total = splits[k], None
        for i in range(m // s):
            b = None
            for p in lanes[i * s:(i + 1) * s]:
                b = add(b, p)
            total = add(total, mul(b, i + 1) if b is not None else None)
        out.append(total)
    return out


CASES = [("g1", 16, [1, 1, 2, 4]), ("g2", 8, [1, 2, 2])]


@pytest.mark.parametrize("group,m,splits", CASES)
def test_reduce_plain_equals_the_old_chain(group, m, splits):
    acc = _buckets(group, len(splits), m, seed=80)
    got = K.curve_bucket_reduce_plain(group, acc, splits)
    assert torch.equal(got, _old_reduce(group, acc, splits))
    assert affine_points(group, got) == _oracle_weighted(group, acc, splits)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_combine_plain_equals_the_old_chain(group):
    c = 3
    pts = _windows(group, c, 6, seed=81)
    got = K.curve_window_combine_plain(group, pts, c)
    assert torch.equal(got, _old_combine(group, pts, c))
    add = oc.g1_add if group == "g1" else oc.g2_add
    mul = oc.g1_mul if group == "g1" else oc.g2_mul
    want = None
    for w, p in enumerate(affine_points(group, pts)):
        if p is not None:
            want = add(want, mul(p, 1 << (c * w)))
    assert affine_points(group, got[..., None]) == [want]


def test_combine_matches_jax():
    """The JAX package's window scaling (`curve_horner_scale`, the kernel
    of `ultragroth_tpu/ops/msm.py:443-460`), its windows summed by the
    oracle, against the plain combine after to_affine (the JAX fold's
    eager compile is left to the `slow` test below)."""
    c, w = 3, 5
    pts = _windows("g1", c, w, seed=82)
    j = jk.curve_horner_scale("g1", c, w)(*xyzz_to_jax("g1", pts))
    want = None
    for p in affine_points("g1", xyzz_from_jax("g1", j)):
        want = oc.g1_add(want, p)
    got = K.curve_window_combine_plain("g1", pts, c)
    assert affine_points("g1", got[..., None]) == [want]


@pytest.mark.slow
@pytest.mark.parametrize("group,m,splits", [("g1", 8, [1, 1, 2]),
                                            ("g2", 8, [1, 2])])
def test_reduce_and_combine_match_jax(group, m, splits):
    """The JAX package's pre-folds and `_weighted_totals` per split group
    (`ultragroth_tpu/ops/msm.py:482-494`), then its window combine
    (`curve_horner_scale` and the zero-padded pairwise fold, :496-507),
    after to_affine."""
    acc = _buckets(group, len(splits), m, seed=83)
    jops = jg1_ops() if group == "g1" else jg2_ops()
    aw = jk.curve_add_where(group)
    sums = []
    for w, s in enumerate(splits):
        j = xyzz_to_jax(group, acc[..., w, :].contiguous())
        j = jax.tree_util.tree_map(lambda t: t[:, None, :], j)
        for _ in range(s.bit_length() - 1):
            j = jm._fold_pairs(aw, j)
        sums.append(jm._weighted_totals(jops, aw, j, m // s))
    got = K.curve_bucket_reduce_plain(group, acc, splits)
    assert affine_points(group, got) == [
        affine_points(group, xyzz_from_jax(group, t))[0] for t in sums]
    c, w = 2, len(splits)
    stacked = jax.tree_util.tree_map(lambda *ts: np.concatenate(ts, -1), *sums)
    j = jk.curve_horner_scale(group, c, w)(*stacked)
    j = jax.tree_util.tree_map(
        lambda t: np.pad(np.asarray(t), ((0, 0), (0, 4 - w))), j)
    while jax.tree_util.tree_leaves(j)[0].shape[-1] > 1:
        j = jm._fold_pairs(aw, j)
    comb = K.curve_window_combine_plain(group, got, c)
    assert affine_points(group, comb[..., None]) == affine_points(
        group, xyzz_from_jax(group, j))


def test_reduce_plan_and_launches():
    """Wide levels down to REDUCE_TAIL_WIDTH, then one tail: 9 launches
    for the variable-base MSM at c = 13 (two split groups), 13 for the
    fixed-base one at c = 17."""
    splits = [1] * 19 + [32]
    steps, tail, u, cap = K.reduce_plan(4096, splits)
    assert len(steps) + 1 == K.bucket_reduce_launches(4096) == 9
    assert K.bucket_reduce_launches(1 << 16) == 13
    assert K.bucket_reduce_launches(8) == 1
    assert u == K.REDUCE_TAIL_WIDTH and [len(s) for s in steps] == [2] * 8
    # the main group banks every level, the split group after 5 pre-folds
    assert [g[1:] for g in tail] == [(19, 0, 9, 0), (1, 19, 4, 0)]
    assert cap == max(sum(r[2] + r[4] for r in s) for s in steps)
    for bad in ([1] * 19, [1] * 19 + [3], [1] * 19 + [8192]):
        with pytest.raises(ValueError):
            K.curve_bucket_reduce("g1", torch.zeros(4, 8, 20, 4096,
                                                    dtype=torch.int64), bad)


# -- the kernels' bodies, built for the host -------------------------------

@pytest.fixture(scope="module", params=["cios", "mma"])
def harness(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available to build the host harness")
    out = tmp_path_factory.mktemp("harness") / "libug_host.so"
    defines = ["-DUG_MMA_FIELD=1"] if request.param == "mma" else []
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", *defines,
                    "-o", str(out), str(REPO / "ultragroth_tpu_torch" / "csrc" /
                                        "host_harness.cpp")], check=True)
    lib = ctypes.CDLL(str(out), mode=os.RTLD_LOCAL)
    assert lib.ugh_mma_build() == (request.param == "mma")
    return lib


def _harness_reduce(lib, group, acc, splits):
    """The wrapper's launches (reduce_plan's wide levels, then the tail)
    through the harness's reduce_step and reduce_tail."""
    A = _Args()
    i64, cint = ctypes.c_int64, ctypes.c_int
    e = _elem(group)
    w, m = acc.shape[-2:]
    steps, tail, u, cap = K.reduce_plan(m, splits)
    src, src_n = A.u32(acc), w * m
    for segs in steps:
        dst = np.zeros((4, *e, 8, cap), np.uint32)
        desc = np.ascontiguousarray(np.array(segs, np.int64))
        A.keep += [dst, desc]
        getattr(lib, f"ugh_{group}_reduce_step")(
            A.p(src), i64(src_n), A.p(dst), i64(cap), A.p(desc),
            cint(len(segs)), i64(sum(s[2] for s in segs)))
        src, src_n = dst, cap
    out = np.zeros((4, *e, 8, w), np.uint32)
    desc = np.ascontiguousarray(np.array(tail, np.int64))
    A.keep.append(desc)
    getattr(lib, f"ugh_{group}_reduce_tail")(
        A.p(src), i64(src_n), A.p(desc), cint(len(tail)), i64(w), cint(u),
        cint(max(g[3] for g in tail)), A.p(out), i64(w))
    return out


@functools.cache
def _reduce_case(group, m, splits):
    """(buckets, their plain reduction), made once for both builds."""
    acc = _buckets(group, len(splits), m, seed=84)
    return acc, K.curve_bucket_reduce_plain(group, acc, list(splits))


@functools.cache
def _combine_case(group, c, w):
    """(window sums, their plain combine), made once for both builds."""
    pts = (_windows(group, c, w, seed=85) if w == 6 else
           _points(group, w, seed=86))
    return pts, K.curve_window_combine_plain(group, pts, c)


@pytest.mark.parametrize("group,m,splits", CASES + [("g1", 64, [1, 1, 4, 8]),
                                                    ("g2", 32, [1, 1, 2])])
def test_reduce_bodies_match_plain(harness, group, m, splits):
    """Without wide levels (m <= REDUCE_TAIL_WIDTH: the tail alone) and
    with them (pre-folds across the wide levels and into the tail)."""
    acc, want = _reduce_case(group, m, tuple(splits))
    got = _harness_reduce(harness, group, acc, splits)
    np.testing.assert_array_equal(got, _Args().u32(want))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_combine_body_matches_plain(harness, group):
    """Six windows and 40, over the kernel's blocks of one warp (32 / T
    windows each), the last block folding."""
    for c, w in ((3, 6), (1, 40)):
        pts, want = _combine_case(group, c, w)
        A = _Args()
        out = np.zeros((4, *_elem(group), 8, 1), np.uint32)
        left = getattr(harness, f"ugh_{group}_window_combine")(
            A.p(A.u32(pts)), ctypes.c_int64(w), ctypes.c_int(c), A.p(out))
        assert left == 0           # the folding block reset the counter
        np.testing.assert_array_equal(out[..., 0], A.u32(want))


def test_fq_chain_body_matches_plain(harness):
    A = _Args()
    a = lb.ints_to_planes(sample(R, 8, seed=87))
    b = lb.ints_to_planes(sample(R, 8, seed=88))
    out = np.zeros((8, 8), np.uint32)
    harness.ugh_fq_chain(A.p(A.u32(a)), A.p(A.u32(b)), A.p(out),
                         ctypes.c_int64(8), ctypes.c_int32(5))
    np.testing.assert_array_equal(out, A.u32(K.fq_mul_chain(a, b, 5)))
