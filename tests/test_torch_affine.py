"""PyTorch port: the per-key point chains of csrc/chains.cuh, each one
launch ending in an in-kernel batch to-affine: `curve_fixed_base_mul`
(the device set-up's 8-bit windowed fixed-base ladder) and
`curve_window_table` (the windows of a fixed-base MSM table).

Their plain versions (the per-step paths they replace: 32
`curve_madd_valid_plain` steps and `CurveOps.to_affine`;
`curve_add_where_plain(P, P)` doublings and a to-affine a window) are held
against the oracle (scalar * G; 2^(c*w) * P); the kernels' block programs,
built for the host with g++ in both field builds (`-DUG_MMA_FIELD=1`) and
run phase by phase, thread by thread, bit for bit against the plain
versions; the field's inversion (`Field::inv`, `Fq2Over::inv`) against
Python's.  The comparisons with the JAX package (`testkit/dsetup.py:
_fb_run`, `ops/msm.py:msm_fixed_table`) are `slow`: each is a cold
XLA:CPU compile of a scan of Pallas kernels.

Edge lanes: scalar 0, scalars with zero bytes in several windows, 1, r - 1,
a block of lanes all at infinity, a ragged last block; points at infinity
among the table's inputs; c = 10 (25 windows) on 160 lanes and c = 17 (the
2^20 tables' window, 14 windows) on 64.  The plain versions run on one
torch thread (their cost is the count of tensor ops, which the intra-op
pool only slows at these widths) and once per case.
"""
import contextlib
import ctypes
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import table_from_planes
from ultragroth_tpu_torch.ops.field import fq
from ultragroth_tpu_torch.ops.msm import fixed_n_windows
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.testkit.dsetup import _fb_table

from tests.test_torch_kernels import _Args
from tests.test_torch_mxufield import _harness

BLOCK = 128           # csrc/chains.cuh kChainThreads
LANES = {"g1": 300, "g2": 160}


@contextlib.contextmanager
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """build ("cios" | "mma") -> the host harness of that field build,
    compiled at its first use."""
    libs = {}

    def get(build):
        if build not in libs:
            libs[build] = _harness(tmp_path_factory, [] if build == "cios"
                                   else ["-DUG_MMA_FIELD=1"])
            assert libs[build].ugh_mma_build() == (build == "mma")
        return libs[build]
    return get


def _scalars(group):
    """Lane scalars: block 0 with the edges (0, 1, r - 1, zero bytes in
    several windows, a lone top byte, 256^k), random canonical ones
    elsewhere; every lane of block 1 zero (all at infinity); G1's block 2
    ragged (44 lanes), G2's block 1 ragged (32)."""
    rng = random.Random(7 if group == "g1" else 8)
    n = LANES[group]
    s = [rng.randrange(R) for _ in range(n)]
    s[:6] = [0, 1, R - 1, 0x30 << 248, 1 << 64, 256 ** 31]
    for k in range(6, 14):             # zero bytes in windows 3, 7, ..
        v = rng.randrange(R)
        for w in range(k % 4 + 3, 32, 4):
            v &= ~(0xFF << (8 * w))
        s[k] = v
    s[BLOCK:min(2 * BLOCK, n)] = [0] * (min(2 * BLOCK, n) - BLOCK)
    return s


def _affine_ints(group, x, y, inf):
    """Montgomery affine planes -> oracle points (None at infinity)."""
    F = fq()
    if group == "g1":
        xs = lb.planes_to_ints(F.from_mont(x))
        ys = lb.planes_to_ints(F.from_mont(y))
        return [None if inf[i] else (xs[i], ys[i]) for i in range(len(xs))]
    v = [lb.planes_to_ints(F.from_mont(t)) for t in (x[0], x[1], y[0], y[1])]
    return [None if inf[i] else ((v[0][i], v[1][i]), (v[2][i], v[3][i]))
            for i in range(len(v[0]))]


def _mul_g(group, k):
    return (oc.g1_mul(oc.G1, k % R) if group == "g1"
            else oc.g2_mul(oc.G2, k % R))


@functools.cache
def _ladder_case(group):
    """(table, tinf, scalars [8, n], the plain ladder's (x, y, inf))."""
    table, tinf = _fb_table(group, "cpu")
    sc = lb.ints_to_planes(_scalars(group))
    with _one_thread():
        out = K.curve_fixed_base_mul_plain(group, table, tinf, sc)
    return table, tinf, sc, out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_mul_plain_matches_oracle(group):
    _, _, _, (x, y, inf) = _ladder_case(group)
    scalars = _scalars(group)
    assert _affine_ints(group, x, y, inf) == [_mul_g(group, s) for s in scalars]
    assert inf.tolist() == [s == 0 for s in scalars]
    assert not bool(x[..., inf].any()) and not bool(y[..., inf].any())


@pytest.mark.parametrize("build", ["cios", "mma"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_mul_body_matches_plain(harness, build, group):
    """ugh_*_fixed_base_mul: every block's program thread by thread."""
    chain_lib = harness(build)
    table, tinf, sc, (x, y, inf) = _ladder_case(group)
    n = sc.shape[1]
    A = _Args()
    out = np.zeros((2, *x.shape[:-1], n), np.uint32)
    out_inf = np.full(n, 7, np.uint8)
    tinf_u = np.ascontiguousarray(tinf.numpy().astype(np.uint8))
    assert getattr(chain_lib, f"ugh_{group}_fixed_base_mul")(
        A.p(A.u32(table)), A.p(tinf_u), ctypes.c_int64(table.shape[-1]),
        A.p(A.u32(sc)), A.p(out), A.p(out_inf), ctypes.c_int64(n)) == 0
    np.testing.assert_array_equal(out[0], A.u32(x))
    np.testing.assert_array_equal(out[1], A.u32(y))
    np.testing.assert_array_equal(out_inf, inf.numpy().astype(np.uint8))


def test_fixed_base_mul_wrapper_on_the_cpu_is_the_plain_version():
    table, tinf, sc, want = _ladder_case("g1")
    K.reset_launch_counts()
    with _one_thread():
        got = K.curve_fixed_base_mul("g1", table, tinf, sc[:, :40])
    assert all(torch.equal(g, w[..., :40]) for g, w in zip(got, want))
    assert sum(K.launch_counts().values()) == 0
    with pytest.raises(ValueError):       # 31 windows of a table
        K.curve_fixed_base_mul("g1", table[..., :256 * 31], tinf[:256 * 31],
                               sc)


# -- the window table ---------------------------------------------------------

TABLE_CASES = [("g1", 10, 160), ("g1", 17, 64), ("g2", 10, 160),
               ("g2", 17, 64)]


@functools.cache
def _table_case(group, c, n):
    """Window 0: the ladder's outputs for lanes < n (known logs: their
    scalars; lanes of scalar 0 at infinity, (0, 0)), the point-major
    [n, 2, *elem]; and the plain version's whole table."""
    _, _, _, (x, y, inf) = _ladder_case(group)
    base = table_from_planes(torch.stack([x[..., :n], y[..., :n]]))
    pinf = inf[:n].clone()
    nw = fixed_n_windows(c)
    out = torch.zeros((nw * n,) + tuple(base.shape[1:]), dtype=base.dtype)
    out[:n] = base
    with _one_thread():
        K.curve_window_table_plain(group, out[:n], pinf, c, out)
    return base, pinf, out


@pytest.mark.parametrize("group,c,n", TABLE_CASES)
def test_window_table_plain_matches_oracle(group, c, n):
    """Rows of every window for the edge lanes (infinity among them) and
    a random sample: row w * n + i == 2^(c*w) * s_i * G."""
    base, pinf, out = _table_case(group, c, n)
    scalars = _scalars(group)
    nw = out.shape[0] // n
    assert nw - 1 == {10: 25, 17: 14}[c]
    rng = random.Random(c)
    lanes = sorted({0, 1, 2, 5, 6, n - 1} | {rng.randrange(n) for _ in range(4)})
    for w in range(nw):
        rows = out[w * n + torch.tensor(lanes)]
        planes = rows.movedim(0, -1)
        got = _affine_ints(group, planes[0], planes[1],
                           [scalars[i] == 0 for i in lanes])
        assert got == [_mul_g(group, scalars[i] << (c * w)) for i in lanes]
        inf_rows = out[w * n:(w + 1) * n][pinf]
        assert not bool(inf_rows.any())                  # infinity is (0, 0)


# the mma build's host product is ~15x the CIOS one's: its G2 table runs
# the 2^20 tables' c = 17 alone
TABLE_BODIES = ([("cios", *case) for case in TABLE_CASES]
                + [("mma", "g1", 10, 160), ("mma", "g1", 17, 64),
                   ("mma", "g2", 17, 64)])


@pytest.mark.parametrize("build,group,c,n", TABLE_BODIES)
def test_window_table_body_matches_plain(harness, build, group, c, n):
    """ugh_*_window_table: every block's program thread by thread, into
    the rows of the table after window 0."""
    chain_lib = harness(build)
    base, pinf, want = _table_case(group, c, n)
    A = _Args()
    out = np.zeros(tuple(want.shape), np.uint32)
    out[:n] = A.u32(base)
    inf_u = np.ascontiguousarray(pinf.numpy().astype(np.uint8))
    assert getattr(chain_lib, f"ugh_{group}_window_table")(
        A.p(out), A.p(inf_u), A.p(out), ctypes.c_int64(n), ctypes.c_int(c),
        ctypes.c_int(want.shape[0] // n)) == 0
    np.testing.assert_array_equal(out, A.u32(want))


# -- the field's inversion ----------------------------------------------------

@pytest.mark.parametrize("build", ["cios", "mma"])
def test_field_inverse_matches_python(harness, build):
    """Fermat a^(q-2) in the Montgomery domain (inv(aR) = a^-1 R, inv(0) =
    0), on canonical and lazy [q, 2q) inputs; Fq2 through the norm."""
    chain_lib = harness(build)
    F = fq()
    rng = random.Random(3)
    vals = [0, 1, 2, Q - 1, Q + 5, 2 * Q - 1] + [rng.randrange(Q)
                                                 for _ in range(10)]
    # the Montgomery forms: lazy inputs stay lazy (their canonical value
    # shifted by q)
    mont = [v if v >= Q else v * (1 << 256) % Q for v in vals]
    plain = [v % Q for v in mont]
    A = _Args()
    out = np.zeros((8, len(vals)), np.uint32)
    chain_lib.ugh_fq_inv(1, A.p(A.u32(lb.ints_to_planes(mont))), A.p(out),
                         ctypes.c_int64(len(vals)))
    got = lb.planes_to_ints(torch.from_numpy(out.astype(np.int64)))
    r = (1 << 256) % Q
    want = [0 if m == 0 else pow(m * pow(r, -1, Q) % Q, -1, Q) * r % Q
            for m in plain]
    assert got == want
    pairs = [(0, 0), (1, 0), (0, 1), (Q - 1, 7)] + [
        (rng.randrange(Q), rng.randrange(Q)) for _ in range(6)]
    a = torch.stack([F.to_mont(lb.ints_to_planes([p[k] for p in pairs]))
                     for k in range(2)])
    out = np.zeros((2, 8, len(pairs)), np.uint32)
    chain_lib.ugh_fq_inv(2, A.p(A.u32(a)), A.p(out), ctypes.c_int64(len(pairs)))
    inv = torch.from_numpy(out.astype(np.int64))
    got = [tuple(lb.planes_to_ints(F.from_mont(inv[k]))) for k in range(2)]
    for i, (a0, a1) in enumerate(pairs):
        nrm = (a0 * a0 + a1 * a1) % Q
        ni = pow(nrm, -1, Q) if nrm else 0
        assert (got[0][i], got[1][i]) == (a0 * ni % Q, -a1 * ni % Q)


# -- against the JAX package --------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_mul_matches_jax_fb_run(group):
    """The JAX device set-up's `_fb_run` (32 `curve_madd_valid` steps under
    a scan, then to_affine) on the same scalars."""
    from ultragroth_tpu.testkit import dsetup as jd
    _, _, sc, (x, y, inf) = _ladder_case(group)
    n = 64
    jx, jy, jinf = jd._fixed_base_points(group, convert.from_torch(sc[:, :n]))
    comps = (lambda t: [t]) if group == "g1" else (lambda t: list(t))
    for mine, theirs in ((x, jx), (y, jy)):
        want = torch.stack([convert.to_torch(np.asarray(c)) for c in
                            comps(theirs)])
        assert torch.equal(mine[..., :n].reshape(want.shape), want)
    assert inf[:n].tolist() == np.asarray(jinf).tolist()


@pytest.mark.slow
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_table_matches_jax_fixed_table(group):
    """The JAX package's `msm_fixed_table` on the same 64 points at c = 5,
    carried into the port's layout (`convert.fixed_table_from_jax`), equal
    to `msm_fixed_table`'s whole table."""
    from ultragroth_tpu.ops import msm as jmsm
    from ultragroth_tpu_torch.ops import msm as pmsm
    base, pinf, _ = _table_case(group, 17, 64)
    planes = base.movedim(0, -1)
    if group == "g1":
        jx, jy = (jnp.asarray(convert.from_torch(planes[k])) for k in range(2))
    else:
        jx, jy = (tuple(jnp.asarray(convert.from_torch(planes[k][j]))
                        for j in range(2)) for k in range(2))
    packed, jinf, c = jmsm.msm_fixed_table(group, jx, jy,
                                           jnp.asarray(pinf.numpy()), c=5)
    want, winf = convert.fixed_table_from_jax(packed, jinf)
    with _one_thread():
        mine, minf, _ = pmsm.msm_fixed_table(group, base, pinf, 5)
    assert torch.equal(mine, want) and torch.equal(minf, winf)
