"""PyTorch port: NTT, quotient and R1CS scatter against the JAX package
(base NTT mode, as its CPU tests run it) and the oracle; MSM G1 / G2
against the oracle on the cases of tests/test_ntt_msm.py, with the JAX
package's own MSM compared in a `slow` test (its CPU compile of one MSM
shape takes many minutes).  Exact on integers.
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import limbs as jlb
from ultragroth_tpu.ops import msm as dmsm
from ultragroth_tpu.ops import ntt as dntt
from ultragroth_tpu.ops.field import fr as jfr
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops import msm as M
from ultragroth_tpu_torch.ops import ntt as N
from ultragroth_tpu_torch.ops.field import fr
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol import quotient as oq
from ultragroth_tpu_torch.protocol.transcript import root_of_unity

from tests.test_torch_field import affine_points, point_table, sample


def test_ntt_matches_jax_and_oracle():
    log_n = 4
    vals = sample(R, 1 << log_n, seed=41)
    F = fr()
    a = F.to_mont(lb.ints_to_planes(vals))
    dom = N.Domain(log_n, "cpu")
    fwd = N.ntt(a, dom)
    jfwd = dntt.ntt(jfr().to_mont(jlb.ints_to_planes(vals)), log_n)
    assert torch.equal(fwd, convert.to_torch(np.asarray(jfwd)))
    assert lb.planes_to_ints(F.from_mont(fwd)) == oq.ntt(vals, root_of_unity(log_n))
    back = N.ntt(fwd, dom, inverse=True)
    assert lb.planes_to_ints(F.from_mont(back)) == vals


def test_quotient_scalars_matches_jax_and_oracle():
    log_n = 3
    n = 1 << log_n
    a_vals, b_vals = sample(R, n, seed=42), sample(R, n, seed=43)
    F = fr()
    a = F.to_mont(lb.ints_to_planes(a_vals))
    b = F.to_mont(lb.ints_to_planes(b_vals))
    got = N.quotient_scalars(a, b, N.Domain(log_n, "cpu"))
    jf = jfr()
    exp = dntt.quotient_scalars(jf.to_mont(jlb.ints_to_planes(a_vals)),
                                jf.to_mont(jlb.ints_to_planes(b_vals)), log_n)
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))
    assert lb.planes_to_ints(got) == oq.quotient_evals(a_vals, b_vals, n)


def test_scatter_coefs_matches_jax_and_oracle():
    domain, n_vars, n_coefs = 16, 10, 200
    rng = np.random.default_rng(44)
    wit = sample(R, n_vars, seed=45)
    coef_vals = sample(R, n_coefs, seed=46)
    m = rng.integers(0, 2, n_coefs).astype(np.uint32)
    c = rng.integers(0, domain, n_coefs).astype(np.uint32)
    s = rng.integers(0, n_vars, n_coefs).astype(np.uint32)
    F = fr()
    wm = F.to_mont(lb.ints_to_planes(wit))
    cv = F.to_mont(lb.ints_to_planes(coef_vals))
    a, b = N.scatter_coefs(wm, cv, torch.from_numpy(m.astype(np.int64)),
                           torch.from_numpy(c.astype(np.int64)),
                           torch.from_numpy(s.astype(np.int64)), domain)
    jf = jfr()
    ja, jb = dntt.scatter_coefs(jf.to_mont(jlb.ints_to_planes(wit)),
                                jf.to_mont(jlb.ints_to_planes(coef_vals)),
                                m, c, s, domain)
    assert torch.equal(a, convert.to_torch(np.asarray(ja)))
    assert torch.equal(b, convert.to_torch(np.asarray(jb)))
    exp_a, exp_b = oq.scatter_coefs(m, c, s, coef_vals, wit, domain)
    assert lb.planes_to_ints(F.from_mont(a)) == exp_a
    assert lb.planes_to_ints(F.from_mont(b)) == exp_b


def _g1_case(kind):
    rng = random.Random(47)
    if kind == "general":          # infinity base, repeated base, 0 scalar
        n, c = 40, 8
        pts = [oc.g1_mul(oc.G1, rng.randrange(1, R)) for _ in range(n - 2)]
        pts += [None, pts[0]]
        scalars = [rng.randrange(R) for _ in range(n - 3)] + [0, 5, R - 1]
    elif kind == "all_equal_digits":   # one bucket; 1G + 2G meets 3G
        n, c = 24, 4
        pts = [oc.g1_mul(oc.G1, i + 1) for i in range(n)]
        scalars = [3] * n
    elif kind == "two_phase_skew":
        # c = 10: 26 windows x 512 buckets, one bucket per window holding
        # every point (the JAX loop's two phases) and a duplicate point
        n, c = 24, 10
        pts = [oc.g1_mul(oc.G1, i + 1) for i in range(n - 1)]
        pts.append(pts[0])
        scalars = [(1 << 200) + 12345] * n
    elif kind == "dup_and_negation":
        # one bucket per window meets P + (-P), inf + P, P + P and Q + (-Q)
        n, c = 8, 8
        a, b, d = (oc.g1_mul(oc.G1, rng.randrange(1, R)) for _ in range(3))
        neg = lambda p: oc.g1_mul(p, R - 1)
        pts = [a, neg(a), a, a, b, neg(b), d, d]
        scalars = [rng.randrange(1 << 250)] * n
    else:                          # spare window: 254 % 2 == 0
        n, c = 12, 2
        pts = [oc.g1_mul(oc.G1, rng.randrange(1, R)) for _ in range(n)]
        scalars = [R - 1 - i for i in range(n)]
    return pts, scalars, c


@pytest.mark.parametrize("kind", ["general", "all_equal_digits",
                                  "two_phase_skew", "spare_window",
                                  "dup_and_negation"])
def test_msm_g1_vs_oracle(kind):
    pts, scalars, c = _g1_case(kind)
    table, inf = point_table("g1", pts)
    out = M.msm_g1(table, inf, lb.ints_to_planes(scalars), c=c)
    # outputs leave canonical (< q): nothing lazy escapes a kernel
    assert all(v < Q for v in lb.planes_to_ints(out.T))
    assert affine_points("g1", out[..., None])[0] == oc.g1_msm(pts, scalars)


def test_msm_g2_vs_oracle():
    rng = random.Random(48)
    n, c = 17, 8
    pts = [oc.g2_mul(oc.G2, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    table, inf = point_table("g2", pts)
    out = M.msm_g2(table, inf, lb.ints_to_planes(scalars), c=c)
    assert affine_points("g2", out[..., None])[0] == oc.g2_msm(pts, scalars)


def test_msm_of_no_points_is_infinity():
    table, inf = point_table("g1", [])
    out = M.msm_g1(table, inf, lb.ints_to_planes([]), c=8)
    assert affine_points("g1", out[..., None]) == [None]


def test_msm_rejects_non_canonical_scalars():
    """A scalar >= r would silently lose points in the split top windows
    (JAX package ops/msm.py:127-143); the port refuses it."""
    pts = [oc.g1_mul(oc.G1, 2), oc.g1_mul(oc.G1, 3)]
    table, inf = point_table("g1", pts)
    with pytest.raises(ValueError):
        M.msm_g1(table, inf, lb.ints_to_planes([1, R]), c=8)


def test_window_bookkeeping_matches_jax():
    for c in (2, 8, 10, 12, 13, 16):
        assert M.n_windows_for(c) == -(-254 // c) + (254 % c == 0)
        for w in range(M.n_windows_for(c)):
            assert M._split_factor(w, c) == dmsm._split_factor(w, c)
    for n in (10, 1 << 12, 1 << 16, (1 << 20) - 6, 1 << 22):
        assert M.default_window(n) == dmsm.default_window(n)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["all_equal_digits", "two_phase_skew"])
def test_msm_g1_matches_jax_msm(kind):
    import jax
    from tests.test_curve_ops import g1_batch_to_planes, g1_affine_from_device
    pts, scalars, c = _g1_case(kind)
    x, y, inf = g1_batch_to_planes(pts)
    jout = dmsm.msm_g1(x, y, inf, jlb.ints_to_planes(scalars), c=c)
    exp = g1_affine_from_device(*jax.jit(dmsm.g1_ops().to_affine)(jout))[0]
    table, tinf = point_table("g1", pts)
    out = M.msm_g1(table, tinf, lb.ints_to_planes(scalars), c=c)
    assert affine_points("g1", out[..., None])[0] == exp
