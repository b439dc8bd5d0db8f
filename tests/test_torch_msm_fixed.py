"""PyTorch port: fixed-base MSM (`ops/msm.py:msm_fixed_table`, `msm_fixed`)
and the provers' table plan (`protocol/prover.py:_build_fixed_tables`).

The MSM over the precomputed table against the oracle, G1 and G2, at
c = 4 to 6, with a tail window, fewer scalars than table columns,
duplicate points, P and -P, and a point at infinity; the table's columns
against the oracle's 2^(c*w) * P_i; the window and plan arithmetic against
the JAX package's; a CPU prove with a table equal to the oracle prover's
proof.  The comparison with the JAX package's `msm_fixed_table` /
`msm_g1_fixed` (through `convert.fixed_table_from_jax`) is `slow`: a JAX
MSM compile takes minutes on the CPU.
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import msm as jmsm
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import table_from_planes, table_planes
from ultragroth_tpu_torch.ops import msm as pmsm
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol.prover import fixed_table_plan

from tests.test_torch_field import (affine_points, g1_table, point_table,
                                    random_points)


def _case(group, n, seed):
    """Points with a duplicate, P and -P and one at infinity; scalars
    with a zero, r - 1 and a duplicate scalar."""
    pts = random_points(group, n, seed)
    mul = oc.g1_mul if group == "g1" else oc.g2_mul
    pts[3] = pts[2]                       # duplicate point
    pts[5] = mul(pts[4], R - 1)           # -P
    pts[7] = None                         # infinity
    rng = random.Random(seed)
    sc = [rng.randrange(R) for _ in range(n)]
    sc[0], sc[1], sc[6] = 0, R - 1, sc[4]
    return pts, sc


def _oracle_msm(group, pts, sc):
    add = oc.g1_add if group == "g1" else oc.g2_add
    mul = oc.g1_mul if group == "g1" else oc.g2_mul
    total = None
    for p, s in zip(pts, sc):
        if p is not None:
            total = add(total, mul(p, s))
    return total


@pytest.mark.parametrize("group,c,n", [("g1", 4, 20), ("g1", 6, 40),
                                       ("g2", 5, 12)])
def test_msm_fixed_matches_oracle(group, c, n):
    """The MSM over the table, fewer scalars than columns (the tail is
    zero-padded); and the table itself: column w * Npad + i is affine
    2^(c*w) * P_i, a point at infinity and the padding (0, 0) in every
    window and flagged in inf."""
    from ultragroth_tpu_torch.ops.curve import curve_ops
    pts, sc = _case(group, n, seed=70 + c)
    table, inf = point_table(group, pts)
    ftab, finf, cc = pmsm.msm_fixed_table(group, table, inf, c)
    nw = pmsm.fixed_n_windows(c)
    assert cc == c and ftab.shape[0] == nw * 64
    assert finf.tolist() == inf.tolist() + [True] * (64 - n)
    got = pmsm.msm_fixed(group, ftab, finf, lb.ints_to_planes(sc[:n - 2]), c)
    assert affine_points(group, got[..., None]) == \
        [_oracle_msm(group, pts[:n - 2], sc[:n - 2])]

    ops = curve_ops(group)
    mul = oc.g1_mul if group == "g1" else oc.g2_mul
    for w in (1, nw - 1):
        cols = table_planes(ftab[w * 64:(w + 1) * 64])
        assert int(cols[..., n:].abs().sum()) == 0
        assert int(cols[..., 7].abs().sum()) == 0            # infinity
        got = affine_points(group, ops.affine_to_xyzz(
            cols[0][..., :8], cols[1][..., :8], finf[:8]))
        assert got == [None if p is None else mul(p, 1 << (c * w))
                       for p in pts[:8]]


@pytest.mark.parametrize("group,c,n,split", [("g1", 2, 8, pmsm.FIXED_SPLIT),
                                             ("g1", 4, 20, 1),
                                             ("g2", 4, 10, 4)])
def test_msm_fixed_merged_row_matches_oracle(group, c, n, split,
                                            monkeypatch):
    """The merged row (every window's entries sorted as one row, one drain
    of `split` sub-lanes a bucket, one reduction) against the oracle: at
    c = 2, where 254 % c == 0 leaves the spare window for the last carry
    (r - 1 and a scalar whose top digits carry reach it), and with 1 and
    4 sub-lanes a bucket."""
    monkeypatch.setattr(pmsm, "FIXED_SPLIT", split)
    pts, sc = _case(group, n, seed=90 + c)
    sc[2] = (1 << 253) + (1 << 252) + 5        # top digits with a carry
    table, inf = point_table(group, pts)
    ftab, finf, _ = pmsm.msm_fixed_table(group, table, inf, c)
    assert pmsm.fixed_n_windows(c) == -(-254 // c) + (254 % c == 0)
    got = pmsm.msm_fixed(group, ftab, finf, lb.ints_to_planes(sc), c)
    assert affine_points(group, got[..., None]) == [_oracle_msm(group, pts,
                                                                sc)]


def test_msm_fixed_never_adds_windows_apart(monkeypatch):
    """No window fold: `msm_fixed` never calls `curve_add_where`, and its
    stages are `msm_stages`' without the combine."""
    from ultragroth_tpu_torch.ops import kernels as K

    def refuse(*args, **kwargs):
        raise AssertionError("msm_fixed called curve_add_where")
    monkeypatch.setattr(K, "curve_add_where", refuse)
    pts, sc = _case("g1", 12, seed=5)
    table, inf = point_table("g1", pts)
    ftab, finf, c = pmsm.msm_fixed_table("g1", table, inf, 4)
    scal = lb.ints_to_planes(sc)
    stages = [name for name, _ in pmsm.msm_fixed_stages("g1", ftab, finf,
                                                         scal, c)]
    assert stages == ["readback", "digits", "sort_bincount", "index_math",
                      "drain", "reduce"]
    got = pmsm.msm_fixed("g1", ftab, finf, scal, c)
    assert affine_points("g1", got[..., None]) == [_oracle_msm("g1", pts, sc)]


def test_msm_fixed_refuses_what_it_does_not_take():
    c = 4
    ftab = torch.zeros(pmsm.fixed_n_windows(c) * 64, 2, 8, dtype=torch.int64)
    finf = torch.zeros(64, dtype=torch.bool)
    with pytest.raises(ValueError):      # scalars must be canonical
        pmsm.msm_fixed("g1", ftab, finf, lb.ints_to_planes([R] * 8), c)
    with pytest.raises(ValueError):      # the table was built for c = 4
        pmsm.msm_fixed("g1", ftab, finf, lb.ints_to_planes([1] * 8), 5)
    with pytest.raises(ValueError):      # more scalars than table points
        pmsm.msm_fixed("g1", ftab, finf, lb.ints_to_planes([1] * 65), c)


def test_window_arithmetic_matches_jax():
    for c in range(2, 24):
        assert pmsm.fixed_n_windows(c) == jmsm.fixed_n_windows(c)
    for log_n in range(0, 25):
        for n in (1 << log_n, (1 << log_n) + 1):
            assert pmsm.default_fixed_window(n) == \
                jmsm.default_fixed_window(n)


def _jax_plan(sizes: dict, budget: float) -> list:
    """The JAX package's `_build_fixed_tables` plan arithmetic
    (ultragroth_tpu/protocol/prover.py:106-124) with its own window
    functions and its layout's bytes per point (128 / 256 B)."""
    plan = []
    for name, (grp, n) in sizes.items():
        npad = max(64, 1 << (n - 1).bit_length())
        c = jmsm.default_fixed_window(npad)
        w = jmsm.fixed_n_windows(c)
        per_pt = 128 if grp == "g1" else 256
        plan.append((w * npad * per_pt, name, grp, c))
    out, spend = [], 0
    for bytes_, name, grp, c in sorted(plan, reverse=True, key=lambda t: t[0]):
        if spend + bytes_ > budget:
            continue
        out.append((bytes_, name, grp, c))
        spend += bytes_
    return out


@pytest.mark.parametrize("mb", [0.05, 1, 30, 1000, 7000])
def test_fixed_table_plan_matches_jax(mb):
    """The same sets and windows as the JAX package would choose, under a
    budget twice as large: the port's table is half the bytes a point."""
    sizes = {"a": ("g1", 1966067), "b1": ("g1", 1966067),
             "b2": ("g2", 1966067), "rc": ("g1", 917496),
             "fc": ("g1", 1048568), "h": ("g1", 1 << 20),
             "small": ("g1", 40)}
    port = fixed_table_plan(sizes, mb * 1e6)
    jax_plan = _jax_plan(sizes, 2 * mb * 1e6)
    assert [(b * 2, n, g, c) for b, n, g, c in port] == jax_plan


def test_prover_msm_dispatches_to_its_fixed_table(monkeypatch):
    """A prover built under a budget holding one G1 set and no G2 set
    tables the first named of the equal G1 sets, as the JAX package does
    (a stable sort, largest first), and that set's MSM runs over its table
    with the variable-base result; the others keep Pippenger.  (The proof
    with all five tables equals the variable-base proof on the card, in
    chip_smoke.py.)"""
    from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
    from ultragroth_tpu_torch.protocol.prover import TorchGroth16Prover
    from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
    from ultragroth_tpu_torch.testkit.setup import groth16_setup
    r1cs, w = square_chain_circuit(5, seed=11)
    zk = parse_groth16_zkey(np.frombuffer(groth16_setup(r1cs, seed=12)
                                          .zkey_bytes, np.uint8))
    monkeypatch.setenv("ULTRAGROTH_FIXED_MSM_MB", "0.11")
    prover = TorchGroth16Prover(zk, device="cpu")
    assert sorted(prover.fixed) == ["a"] and prover.fixed["a"][2] == 10
    calls = []
    monkeypatch.setattr(pmsm, "msm_fixed",
                        lambda *a: calls.append(a[0]) or _fixed(*a))
    scal = lb.words_to_planes(w)
    got = prover._msm("a", "g1", prover.points_a, scal, prover.c_vars)
    assert calls == ["g1"]
    want = pmsm.msm("g1", *prover.points_a, scal, prover.c_vars)
    assert affine_points("g1", got[..., None]) == \
        affine_points("g1", want[..., None])
    prover._msm("b1", "g1", prover.points_b1, scal, prover.c_vars)
    assert calls == ["g1"]


_fixed = pmsm.msm_fixed


@pytest.mark.slow
@pytest.mark.parametrize("group", ["g1"])
def test_msm_fixed_matches_jax(group):
    """The JAX package's table and fixed-base MSM on the same points, its
    table carried into the port's layout (`convert.fixed_table_from_jax`)
    and run through the port's MSM."""
    from ultragroth_tpu.protocol.prover import g1_section_to_planes
    from ultragroth_tpu_torch.ops.curve import curve_ops
    pts, sc = _case(group, 24, seed=91)
    planes, inf = g1_table(pts)
    table = table_from_planes(planes)
    words = lb.planes_to_words(planes.permute(1, 0, 2)).transpose(1, 0, 2)
    x, y, jinf = g1_section_to_planes(np.ascontiguousarray(words))
    packed, pinf, c = jmsm.msm_fixed_table("g1", x, y, jinf, c=5)
    ftab, finf = convert.fixed_table_from_jax(packed, pinf)
    mine, minf, _ = pmsm.msm_fixed_table(group, table, inf, 5)
    assert torch.equal(ftab, mine) and torch.equal(finf, minf)
    scal = lb.ints_to_planes(sc)
    want = jmsm.msm_g1_fixed(packed, pinf, convert.from_torch(scal), c)
    got = pmsm.msm_fixed(group, ftab, finf, scal, c)
    want_pt = torch.stack([convert.to_torch(np.asarray(t)) for t in want])
    ops = curve_ops(group)
    assert affine_points(group, got[..., None]) == \
        affine_points(group, want_pt[..., None])
    assert not bool(ops.is_inf(got[..., None]).any())
