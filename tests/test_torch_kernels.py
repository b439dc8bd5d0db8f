"""PyTorch port: each of the kernels' plain versions against the JAX
package's kernel entries (`ultragroth_tpu.ops.kernels`, run on the CPU as
its own tests run them), G1 and G2, with infinity on either side, P == Q
and P == -Q; and the kernels' own lane bodies (csrc/*.cuh, built for the
host with g++) against the plain versions.  (`fr_cg_ntt`'s network is
held against the JAX package in tests/test_torch_ntt_fast.py.)

Curve outputs are compared after to_affine (the xyzz representative of a
point is not unique); flags exactly.  Widths stay at 16 lanes.
"""
import ctypes
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
from ultragroth_tpu_torch.ops.curve import curve_ops

from tests.test_torch_field import (REPO, affine_points, elem_to_jax,
                                    g1_table, g2_table, random_points, sample,
                                    xyzz_from_jax, xyzz_to_jax)

N = 16


def _case(group):
    """acc (xyzz), the table of gathered points, signs and validity, with
    the edge cases on fixed lanes: acc at infinity (lane 0), acc == Q
    (lane 1), acc == -Q (lane 2), Q past the count (lanes 3, 8)."""
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
    return acc, table, neg, valid


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
    out = K.curve_madd_valid(group, acc, table, tinf, scalars, 1)
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
    jqx, jqy = elem_to_jax(group, table[0]), elem_to_jax(group, table[1])
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


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_lane_bodies_match_plain(host_lib, group):
    ops = curve_ops(group)
    acc, table, neg, valid = _case(group)
    orders, gidx, stride, cnt = _port_gather_args(neg, valid)
    A = _Args()
    i64 = ctypes.c_int64
    acc_u, tab_u = A.u32(acc), A.u32(table)
    ords = [A.p(A.i32(x)) for x in (orders, gidx, stride, cnt)]

    out = np.zeros_like(acc_u)
    flag = np.zeros(N, np.uint8)
    sticky = np.zeros(1, np.int32)
    getattr(host_lib, f"ugh_{group}_madd_fast")(
        A.p(acc_u), A.p(out), A.p(tab_u), i64(N), *ords, ctypes.c_int32(0),
        A.p(flag), A.p(sticky), i64(N))
    exp, eflag = K.curve_madd_fast_plain(group, acc, table, orders, gidx,
                                         stride, cnt, 0)
    np.testing.assert_array_equal(out, A.u32(exp))
    assert flag.astype(bool).tolist() == eflag.tolist()
    assert sticky[0] == 1

    out = np.zeros_like(acc_u)
    getattr(host_lib, f"ugh_{group}_madd_signed")(
        A.p(acc_u), A.p(out), A.p(tab_u), i64(N), *ords, ctypes.c_int32(0),
        i64(N))
    np.testing.assert_array_equal(out, A.u32(K.curve_madd_signed_plain(
        group, acc, table, orders, gidx, stride, cnt, 0)))

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

    pts = A.u32(acc[..., :5].contiguous())
    getattr(host_lib, f"ugh_{group}_horner")(A.p(pts), i64(5), ctypes.c_int(3))
    np.testing.assert_array_equal(pts, A.u32(K.curve_horner_scale_plain(
        group, acc[..., :5].contiguous(), 3)))


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


@pytest.mark.parametrize("log_m,cols", [(1, 3), (3, 1), (4, 5)])
def test_cg_stage_body_matches_plain(host_lib, log_m, cols):
    """One constant-geometry stage of fr_cg_ntt, the g++ build of its
    butterfly body, against one stage of the plain network."""
    m = 1 << log_m
    A = _Args()
    x = lb.ints_to_planes(sample(R, m * cols, seed=40 + log_m)).reshape(
        8, m, cols)
    tw = lb.ints_to_planes(sample(R, m // 2, seed=50 + log_m))
    out = np.zeros((8, m, cols), np.uint32)
    host_lib.ugh_fr_cg_stage(A.p(A.u32(x)), A.p(out), A.p(A.u32(tw)),
                             ctypes.c_int64(m), ctypes.c_int64(cols))
    np.testing.assert_array_equal(out, A.u32(K.cg_stages_plain(x, tw[None])))


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
    with pytest.raises(ValueError):      # horner: one block holds all lanes
        K.curve_horner_scale("g1", torch.zeros(4, 8, 129, dtype=torch.int64), 2)
    with pytest.raises(ValueError):      # a stage must tile the array
        K.fr_butterfly(torch.zeros(8, 12, dtype=torch.int64),
                       torch.zeros(8, 8, dtype=torch.int64))
    with pytest.raises(ValueError):      # a column above the kernel's cap
        K.fr_cg_ntt(torch.zeros(8, 2048, 1, dtype=torch.int64),
                    torch.zeros(11, 8, 1024, dtype=torch.int64))
    with pytest.raises(ValueError):      # the fixed base has 32 windows
        K.curve_madd_valid("g1", torch.zeros(4, 8, 1, dtype=torch.int64),
                           torch.zeros(2, 8, 8192, dtype=torch.int64),
                           torch.zeros(8192, dtype=torch.bool),
                           torch.zeros(8, 1, dtype=torch.int64), 32)


def test_plain_versions_count_no_launches():
    K.reset_launch_counts()
    acc, table, neg, valid = _case("g1")
    orders, gidx, stride, cnt = _port_gather_args(neg, valid)
    K.curve_madd_fast("g1", acc, table, orders, gidx, stride, cnt, 0)
    K.fr_mont_mul(acc[0], acc[1])
    assert set(K.launch_counts()) == set(K.KERNELS)
    assert all(v == 0 for v in K.launch_counts().values())
