"""PyTorch port: each of the kernels' plain versions against the JAX
package's kernel entries (`ultragroth_tpu.ops.kernels`, run on the CPU as
its own tests run them), G1 and G2, with infinity on either side, P == Q
and P == -Q; the plain bucket drain against the JAX package's drain (its
step kernels with the sticky redo) and the oracle; and the kernels' own
lane bodies (csrc/*.cuh, built for the host with g++) against the plain
versions, `fr_cg_ntt`'s block program among them.  (`fr_cg_ntt`'s
network is held against the JAX package in tests/test_torch_ntt_fast.py.)

Curve outputs are compared after to_affine (the xyzz representative of a
point is not unique) against the JAX package and the oracle, exactly
against the lane bodies; flags exactly.  Widths stay at 16-24 lanes.
"""
import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import kernels as jk
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import (curve_ops, table_from_planes,
                                            table_planes)
from ultragroth_tpu_torch.ops.ntt import Domain
from ultragroth_tpu_torch.oracle import curve as oc

from tests.test_torch_field import (REPO, affine_points, elem_to_jax,
                                    g1_table, g2_table, point_table,
                                    random_points, sample, xyzz_from_jax,
                                    xyzz_to_jax)

N = 16


def _case(group):
    """acc (xyzz), the point-major table of gathered points, signs and
    validity, with the edge cases on fixed lanes: acc at infinity (lane 0),
    acc == Q (lane 1), acc == -Q (lane 2), Q past the count (lanes 3, 8)."""
    ops = curve_ops(group)
    pts = random_points(group, 2 * N, seed=11 if group == "g1" else 12)
    table, _ = (g1_table if group == "g1" else g2_table)(pts[:N])
    base, _ = (g1_table if group == "g1" else g2_table)(pts[N:])
    no_inf = torch.zeros(N, dtype=torch.bool)
    acc = ops.dbl(ops.affine_to_xyzz(base[0], base[1], no_inf))
    q_xyzz = ops.affine_to_xyzz(table[0], table[1], no_inf)
    acc[..., 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 1] = q_xyzz[..., 1]
    acc[..., 2] = q_xyzz[..., 2]
    neg = torch.tensor([i % 3 == 0 for i in range(N)])
    neg[1], neg[2] = False, True       # lane 2 adds -Q to acc = Q
    valid = torch.tensor([i not in (3, 8) for i in range(N)])
    return acc, table_from_planes(table), neg, valid


def _fixed_base_case(group):
    """curve_madd_valid's inputs at window w = 1 of a [2, *elem, 512]
    table (entry 256 + d = point d % N, entry 256 at infinity), with the
    edge cases on fixed lanes: acc at infinity (0), acc == Q (1),
    acc == -Q (2), Q at infinity (3), both at infinity (4)."""
    ops = curve_ops(group)
    pts = random_points(group, 2 * N, seed=13 if group == "g1" else 14)
    pts_tab, _ = (g1_table if group == "g1" else g2_table)(pts[:N])
    base, _ = (g1_table if group == "g1" else g2_table)(pts[N:])
    digit = torch.tensor([5, 6, 7, 0, 0] + list(range(9, 9 + N - 5)))
    ent = torch.arange(512)
    table = pts_tab[..., ent % N].contiguous()
    tinf = ent == 256
    scalars = lb.ints_to_planes([int(d) << 8 for d in digit])
    no_inf = torch.zeros(N, dtype=torch.bool)
    acc = ops.dbl(ops.affine_to_xyzz(base[0], base[1], no_inf))
    q = ops.affine_to_xyzz(table[0][..., 256 + digit], table[1][..., 256 + digit],
                           no_inf)
    acc[..., 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 1] = q[..., 1]
    acc[..., 2] = ops.neg(q[..., 2:3])[..., 0]
    acc[..., 4] = ops.inf_xyzz((1,))[..., 0]
    return acc, table, tinf, scalars


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_madd_valid_matches_jax(group):
    acc, table, tinf, scalars = _fixed_base_case(group)
    out = K.curve_madd_valid_plain(group, acc, table, tinf, scalars, 1)
    qx, qy, qinf = K.fixed_base_gather_plain(table, tinf, scalars, 1)
    assert qinf.tolist() == [False] * 3 + [True, True] + [False] * (N - 5)
    jout = jk.curve_madd_valid(group)(
        xyzz_to_jax(group, acc), elem_to_jax(group, qx),
        elem_to_jax(group, qy), jnp.asarray(qinf.numpy()))
    got = affine_points(group, out)
    assert got == affine_points(group, xyzz_from_jax(group, jout))
    assert got[2] is None and got[4] is None          # Q + (-Q), inf + inf
    assert got[3] == affine_points(group, acc[..., 3:4])[0]
    q = curve_ops(group).affine_to_xyzz(qx, qy, qinf)
    assert got[0] == affine_points(group, q[..., :1])[0]      # inf + Q = Q


def _port_gather_args(neg, valid):
    """Trivial gather: lane i reads entry i = i*2 + sign at t = 0."""
    orders = torch.arange(N) * 2 + neg.long()
    return orders, torch.arange(N), torch.ones(N, dtype=torch.long), valid.long()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_madd_kernels_match_jax(group):
    acc, table, neg, valid = _case(group)
    orders, gidx, stride, cnt = _port_gather_args(neg, valid)
    jacc = xyzz_to_jax(group, acc)
    planes = table_planes(table)
    jqx, jqy = elem_to_jax(group, planes[0]), elem_to_jax(group, planes[1])
    jneg, jvalid = jnp.asarray(neg.numpy()), jnp.asarray(valid.numpy())

    out, flag = K.curve_madd_fast_plain(group, acc, table, orders, gidx,
                                        stride, cnt, 0)
    jout, jflag = jk.curve_madd_fast(group)(jacc, jqx, jqy, jneg, jvalid)
    assert flag.tolist() == np.asarray(jflag).tolist()
    assert flag[0] and flag[1] and flag[2] and not flag[3]
    ok = ~flag
    got = affine_points(group, out)
    exp = affine_points(group, xyzz_from_jax(group, jout))
    assert [g for g, k in zip(got, ok) if k] == [e for e, k in zip(exp, ok) if k]

    out = K.curve_madd_signed_plain(group, acc, table, orders, gidx, stride,
                                    cnt, 0)
    jout = jk.curve_madd_signed(group)(jacc, jqx, jqy, ~jvalid, jneg)
    got = affine_points(group, out)
    assert got == affine_points(group, xyzz_from_jax(group, jout))
    assert got[2] is None                 # Q + (-Q)


DRAIN_POINTS = 160


def _drain_case(group, special=True, alt=2, repeat=2, long=128, most=2):
    """A drain over 24 lanes of a 160-point table, the order entries
    column-major (lane i's step t at t*24 + i: gidx i, stride 24).  Lane 0
    is past its count from the start; with `special`, lane 1 adds one
    point `repeat` times (P + P), lane 2 alternates +Q and -Q `alt` times
    (every step exceptional), lane 3 adds -P then P, lane 4 adds `long`
    distinct points; the other lanes 0..`most` random entries.  Returns
    (table, orders, gidx, stride, cnt, points, entries by lane)."""
    pts = random_points(group, DRAIN_POINTS, seed=15 if group == "g1" else 16)
    rng = np.random.default_rng(17 if special else 18)
    lanes = [[]]
    for i in range(1, 24):
        p = int(rng.integers(DRAIN_POINTS))
        if special and i == 1:
            lanes.append([2 * p] * repeat)
        elif special and i == 2:
            lanes.append([2 * p + (t & 1) for t in range(alt)])
        elif special and i == 3:
            lanes.append([2 * p + 1, 2 * p])
        elif special and i == 4:
            lanes.append([2 * k for k in range(long)])
        else:
            k = int(rng.integers(0, most + 1))
            lanes.append(rng.integers(0, 2 * DRAIN_POINTS, size=k).tolist())
    depth = max(len(e) for e in lanes)
    orders = torch.zeros((depth, 24), dtype=torch.long)
    for i, ents in enumerate(lanes):
        orders[:len(ents), i] = torch.tensor(ents, dtype=torch.long)
    table, _ = point_table(group, pts)
    cnt = torch.tensor([len(e) for e in lanes])
    return (table, orders.reshape(-1), torch.arange(24),
            torch.full((24,), 24), cnt, pts, lanes)


def _oracle_drain(group, pts, lanes, t_from=0, t_to=None):
    """Each lane's sum of its signed points over steps [t_from, t_to)."""
    add = oc.g1_add if group == "g1" else oc.g2_add
    neg = oc.g1_neg if group == "g1" else oc.g2_neg
    out = []
    for ents in lanes:
        total = None
        for e in ents[t_from:t_to]:
            total = add(total, neg(pts[e >> 1]) if e & 1 else pts[e >> 1])
        out.append(total)
    return out


def _jax_step(group, table, orders, gidx, stride, cnt, t):
    """Step t's operands of the JAX step kernels: (qx, qy, neg, valid)."""
    valid = t < cnt
    ent = orders[torch.where(valid, gidx + t * stride, 0)]
    q = table_planes(table[ent >> 1])
    return (elem_to_jax(group, q[0]), elem_to_jax(group, q[1]),
            jnp.asarray(((ent & 1) != 0).numpy()), jnp.asarray(valid.numpy()))


def _jax_drain(group, acc, steps):
    """The JAX package's drain (ultragroth_tpu/ops/msm.py:250-276): fast
    steps with a sticky flag; when any lane flagged, every step redone from
    `acc` with the complete add."""
    fast, full = jk.curve_madd_fast(group), jk.curve_madd_signed(group)
    a, flagged = acc, False
    for qx, qy, neg, valid in steps:
        a, flag = fast(a, qx, qy, neg, valid)
        flagged |= bool(np.asarray(flag).any())
    if flagged:
        a = acc
        for qx, qy, neg, valid in steps:
            a = full(a, qx, qy, ~valid, neg)
    return a


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bucket_drain_plain_matches_jax_drain(group):
    """The plain drain against the JAX package's drain run on its step
    kernels as test_madd_kernels_match_jax runs them: the seed (one
    complete step from infinity), then drains of fast steps with the sticky
    redo.  G1 with the exceptional lanes and the 64x lane (a drain over
    step 1, then one over the rest, as the JAX loop's phases split it); G2
    over 3 steps without exceptional lanes past the seed (an eager JAX G2
    complete add takes seconds here; the oracle test covers the rest)."""
    case = (_drain_case(group) if group == "g1"
            else _drain_case(group, special=False, most=3))
    table, orders, gidx, stride, cnt, _, _ = case
    lanes = (table, orders, gidx, stride, cnt)
    n, depth = gidx.shape[0], int(cnt.max())
    ops = curve_ops(group)
    step = [_jax_step(group, *lanes, t) for t in range(depth)]
    qx, qy, neg, valid = step[0]
    a = jk.curve_madd_signed(group)(xyzz_to_jax(group, ops.inf_xyzz((n,))),
                                    qx, qy, ~valid, neg)
    for t0, t1 in ((1, 2), (2, depth)) if group == "g1" else ((1, depth),):
        a = _jax_drain(group, a, step[t0:t1])
    got = K.curve_bucket_drain_plain(group, *lanes)
    assert affine_points(group, got) == affine_points(
        group, xyzz_from_jax(group, a))
    assert torch.equal(K.curve_bucket_drain(group, *lanes), got)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bucket_drain_plain_matches_oracle(group):
    """Longer exceptional runs than the JAX comparison affords: +Q / -Q for
    9 steps, P five times, -P then P, the 64x lane; from infinity, and from
    given accumulators (one lane at infinity) over the steps [2, 7)."""
    table, orders, gidx, stride, cnt, pts, lanes = _drain_case(
        group, alt=9, repeat=5)
    args = (table, orders, gidx, stride, cnt)
    full = K.curve_bucket_drain_plain(group, *args)
    assert affine_points(group, full) == _oracle_drain(group, pts, lanes)
    assert bool(curve_ops(group).is_inf(full[..., [0, 3]]).all())
    head = K.curve_bucket_drain_plain(group, *args, 0, 2)
    head[..., 5] = curve_ops(group).inf_xyzz((1,))[..., 0]
    part = K.curve_bucket_drain_plain(group, *args, 2, 7, acc=head)
    want = _oracle_drain(group, pts, lanes, 2, 7)
    heads = _oracle_drain(group, pts, lanes, 0, 2)
    heads[5] = None
    add = oc.g1_add if group == "g1" else oc.g2_add
    assert affine_points(group, part) == [add(h, w) for h, w in zip(heads,
                                                                     want)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_where_and_horner_match_jax(group):
    ops = curve_ops(group)
    acc, table, _, _ = _case(group)
    b = torch.roll(acc, 1, -1)
    b[..., 5] = acc[..., 5]                          # P == Q: doubling
    b[..., 6] = ops.neg(acc[..., 6:7])[..., 0]       # P == -Q
    b[..., 7] = ops.inf_xyzz((1,))[..., 0]           # Q at infinity
    ok = torch.tensor([i % 4 != 3 for i in range(N)])
    out = K.curve_add_where_plain(group, acc, b, ok)
    jout = jk.curve_add_where(group)(xyzz_to_jax(group, acc),
                                     xyzz_to_jax(group, b),
                                     jnp.asarray(ok.numpy()))
    got = affine_points(group, out)
    assert got == affine_points(group, xyzz_from_jax(group, jout))
    assert got[6] is None

    c, w = 3, 5
    pts = acc[..., :w].contiguous()
    out = K.curve_horner_scale_plain(group, pts, c)
    jout = jk.curve_horner_scale(group, c, w)(*xyzz_to_jax(group, pts))
    got = affine_points(group, out)
    assert got == affine_points(group, xyzz_from_jax(group, jout))


def test_fr_kernels_match_jax():
    a = sample(R, 2 * N, seed=21)
    tw = sample(R, N, seed=22)
    A, TW = lb.ints_to_planes(a), lb.ints_to_planes(tw)
    JA = jnp.asarray(convert.from_torch(A))
    JT = jnp.asarray(convert.from_torch(TW))
    got = K.fr_mont_mul_plain(A[:, :N], A[:, N:])
    exp = jk.fr_mont_mul()(JA[:, :N], JA[:, N:])
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))
    # one stage, one block: u = a[:N], w = a[N:]
    got = K.fr_butterfly_plain(A.clone(), TW)
    hi, lo = jk.fr_butterfly()(JA[:, :N], JA[:, N:], JT)
    assert torch.equal(got[:, :N], convert.to_torch(np.asarray(hi)))
    assert torch.equal(got[:, N:], convert.to_torch(np.asarray(lo)))


# -- the kernels' device functions, built for the host ---------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available to build the host harness")
    out = tmp_path_factory.mktemp("harness") / "libug_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(out), str(REPO / "ultragroth_tpu_torch" / "csrc" /
                                  "host_harness.cpp")], check=True)
    return ctypes.CDLL(str(out))


class _Args:
    """numpy buffers kept alive across a ctypes call."""

    def __init__(self):
        self.keep = []

    def u32(self, t):
        a = np.ascontiguousarray(lb.widen(t).numpy().astype(np.uint32))
        self.keep.append(a)
        return a

    def i32(self, t):
        a = np.ascontiguousarray(t.numpy().astype(np.int32))
        self.keep.append(a)
        return a

    @staticmethod
    def p(a):
        return ctypes.c_void_p(a.ctypes.data)


def _drain_body(host_lib, group, case, t_from, t_to, acc):
    """The harness's bucket drain against the plain drain, bit for bit."""
    table, orders, gidx, stride, cnt = case[:5]
    A = _Args()
    out = np.zeros((4, *((2,) if group == "g2" else ()), 8, gidx.shape[0]),
                   np.uint32)
    getattr(host_lib, f"ugh_{group}_bucket_drain")(
        None if acc is None else A.p(A.u32(acc)), A.p(out), A.p(A.u32(table)),
        *(A.p(A.i32(x)) for x in (orders, gidx, stride, cnt)),
        ctypes.c_int32(t_from), ctypes.c_int32(t_to),
        ctypes.c_int64(gidx.shape[0]))
    np.testing.assert_array_equal(out, A.u32(K.curve_bucket_drain_plain(
        group, table, orders, gidx, stride, cnt, t_from, t_to, acc)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_lane_bodies_match_plain(host_lib, group):
    """The bucket drain from infinity over every step and from given
    accumulators over a window of steps; add_where; the window combine
    (whose doublings are curve_horner_scale's)."""
    ops = curve_ops(group)
    case = _drain_case(group, alt=5, repeat=3, long=40)
    _drain_body(host_lib, group, case, 0, K.DRAIN_ALL, None)
    acc, _, _, _ = _case(group)
    start = torch.cat([acc, acc[..., :8]], -1)          # 24 lanes
    _drain_body(host_lib, group, case, 1, 4, start)

    A = _Args()
    i64 = ctypes.c_int64
    acc_u = A.u32(acc)
    b = torch.roll(acc, 1, -1)
    b[..., 5] = acc[..., 5]
    b[..., 6] = ops.neg(acc[..., 6:7])[..., 0]
    ok = torch.tensor([i % 4 != 3 for i in range(N)])
    ok_u = np.ascontiguousarray(ok.numpy().astype(np.uint8))
    out = np.zeros_like(acc_u)
    getattr(host_lib, f"ugh_{group}_add_where")(
        A.p(acc_u), A.p(A.u32(b)), A.p(ok_u), A.p(out), i64(N))
    np.testing.assert_array_equal(
        out, A.u32(K.curve_add_where_plain(group, acc, b, ok)))

    pts = acc[..., :5].contiguous()
    out = np.zeros(acc.shape[:-1] + (1,), np.uint32)
    getattr(host_lib, f"ugh_{group}_window_combine")(
        A.p(A.u32(pts)), i64(5), ctypes.c_int(3), A.p(out))
    np.testing.assert_array_equal(out[..., 0], A.u32(
        K.curve_window_combine_plain(group, pts, 3)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_madd_valid_lane_body_matches_plain(host_lib, group):
    acc, table, tinf, scalars = _fixed_base_case(group)
    A = _Args()
    out = np.zeros_like(A.u32(acc))
    tinf_u = np.ascontiguousarray(tinf.numpy().astype(np.uint8))
    getattr(host_lib, f"ugh_{group}_madd_valid")(
        A.p(A.u32(acc)), A.p(out), A.p(A.u32(table)), A.p(tinf_u),
        ctypes.c_int64(table.shape[-1]), A.p(A.u32(scalars)), ctypes.c_int(1),
        ctypes.c_int64(N))
    np.testing.assert_array_equal(out, A.u32(K.curve_madd_valid_plain(
        group, acc, table, tinf, scalars, 1)))


# fr_cg_ntt's block program: (log_m, columns, cb, folded split twiddle).
# A block of the CIOS build (512 threads) holds 512, 512, 64 and 4 columns
# at log_m = 1, 3, 6, 10, of the MMA build (256) half as many: column
# counts that fill the last block of both builds and that fill neither,
# over one block and several; natural stores (cb = 0) and the split's
# folded, transposed ones (cb > 0, the only ones the kernel takes).
CG_CASES = [(1, 300, 0, False), (1, 512, 4, True), (3, 5, 0, False),
            (3, 512, 1, True), (6, 40, 0, False), (6, 64, 2, True),
            (6, 200, 4, True), (10, 3, 0, False), (10, 4, 1, True),
            (10, 10, 2, True)]


@functools.cache
def _cg_case(log_m, cols, cb, fold):
    """(x, split twiddles or None, {inverse: (tw, plain output)}), made once
    for both harness builds."""
    m = 1 << log_m
    x = lb.ints_to_planes(sample(R, m * cols, seed=40 + log_m)).reshape(
        8, m, cols)
    stw = lb.ints_to_planes(sample(R, m * cols // cb, seed=50 + log_m)).reshape(
        8, cols // cb, m) if fold else None
    out = {}
    for inverse in (False, True):
        tw = Domain(log_m, "cpu").ntt_twiddles(log_m, inverse)
        out[inverse] = (tw, K.fr_cg_ntt_plain(x, tw, stw, cb))
    return x, stw, out


def _cg_ntt_body(lib, log_m, cols, cb, fold):
    """The harness's fr_cg_ntt (each block's phases thread by thread)
    against the plain version (the constant-geometry network, bit
    reversal, `fr_mont_mul_plain` and permute), forward and inverse."""
    x, stw, want = _cg_case(log_m, cols, cb, fold)
    for tw, plain in want.values():
        A = _Args()
        out = np.zeros(tuple(plain.shape), np.uint32)
        assert lib.ugh_fr_cg_ntt(
            A.p(A.u32(x)), A.p(A.u32(tw)),
            None if stw is None else A.p(A.u32(stw)), A.p(out),
            ctypes.c_int(log_m), ctypes.c_int64(cols), ctypes.c_int64(cb)) == 0
        np.testing.assert_array_equal(out, A.u32(plain))


@pytest.mark.parametrize("log_m,cols,cb,fold", CG_CASES)
def test_cg_ntt_body_matches_plain(host_lib, log_m, cols, cb, fold):
    _cg_ntt_body(host_lib, log_m, cols, cb, fold)


def test_fr_lane_bodies_match_plain(host_lib):
    A = _Args()
    a = lb.ints_to_planes(sample(R, 4 * N, seed=31))
    b = lb.ints_to_planes(sample(R, 4 * N, seed=32))
    wide = lb.ints_to_planes([(1 << 256) - 1 - i for i in range(4 * N)])
    i64 = ctypes.c_int64
    for x, y in ((a, b), (wide, b[:, :1].contiguous())):
        out = np.zeros((8, 4 * N), np.uint32)
        host_lib.ugh_fr_mont_mul(A.p(A.u32(x)), A.p(A.u32(y)), A.p(out),
                                 i64(4 * N), i64(y.shape[1]))
        np.testing.assert_array_equal(out, A.u32(K.fr_mont_mul_plain(x, y)))
    for half in (1, 4, 2 * N):
        tw = b[:, :half].contiguous()
        arr = A.u32(a)
        host_lib.ugh_fr_butterfly(A.p(arr), A.p(A.u32(tw)), i64(4 * N),
                                  i64(half))
        np.testing.assert_array_equal(arr, A.u32(K.fr_butterfly_plain(
            a.clone(), tw)))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):      # the combine: one block, <= 128 windows
        K.curve_window_combine("g1", torch.zeros(4, 8, 129, dtype=torch.int64),
                               2)
    with pytest.raises(ValueError):      # a stage must tile the array
        K.fr_butterfly(torch.zeros(8, 12, dtype=torch.int64),
                       torch.zeros(8, 8, dtype=torch.int64))
    with pytest.raises(ValueError):      # a column above the kernel's cap
        K.fr_cg_ntt(torch.zeros(8, 2048, 1, dtype=torch.int64),
                    torch.zeros(11, 8, 1024, dtype=torch.int64))
    for stw, cb in ((None, 1), (torch.zeros(8, 2, 4, dtype=torch.int64), 0)):
        with pytest.raises(ValueError):  # the transposed store is the folded one
            K.fr_cg_ntt(torch.zeros(8, 4, 2, dtype=torch.int64),
                        torch.zeros(8, 2, dtype=torch.int64), stw, cb)
    with pytest.raises(ValueError):      # a drain's steps run forwards
        K.curve_bucket_drain("g1", torch.zeros(1, 2, 8, dtype=torch.int64),
                             *(torch.zeros(1, dtype=torch.int32),) * 4, 3, 2)
    with pytest.raises(ValueError):      # the fixed base has 32 windows
        K.curve_fixed_base_mul("g1", torch.zeros(2, 8, 8191, dtype=torch.int64),
                               torch.zeros(8191, dtype=torch.bool),
                               torch.zeros(8, 1, dtype=torch.int64))
    with pytest.raises(ValueError):      # the table's rows: whole windows
        K.curve_window_table("g1", torch.zeros(4, 2, 8, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.bool), 3,
                             torch.zeros(10, 2, 8, dtype=torch.int64))


def test_plain_versions_count_no_launches():
    K.reset_launch_counts()
    acc, table, neg, valid = _case("g1")
    orders, gidx, stride, cnt = _port_gather_args(neg, valid)
    K.curve_bucket_drain("g1", table, orders, gidx, stride, cnt, acc=acc)
    K.fr_mont_mul(acc[0], acc[1])
    assert set(K.launch_counts()) == set(K.KERNELS)
    assert all(v == 0 for v in K.launch_counts().values())
