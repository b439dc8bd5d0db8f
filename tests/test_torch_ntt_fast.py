"""PyTorch port: the `fast` NTT mode (Bailey split over `fr_cg_ntt`
columns) against the JAX package's `ntt_fast` and its constant-geometry
network, and against the port's own `base` NTT, which
tests/test_torch_ntt_msm.py holds against the JAX package.  Exact on
integers.  The wider JAX comparisons (tests/test_ntt_fast.py's sizes) are
`slow`: each JAX NTT size is a cold XLA:CPU compile of many seconds.
"""
import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import limbs as jlb
from ultragroth_tpu.ops import ntt as dntt
from ultragroth_tpu.ops.field import fr as jfr
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops import ntt as N
from ultragroth_tpu_torch.ops.field import fr

from tests.test_torch_field import sample


def _mont(n, seed):
    """Canonical Montgomery planes of n sample values, port and JAX."""
    vals = sample(R, n, seed=seed)
    return (fr().to_mont(lb.ints_to_planes(vals)),
            jfr().to_mont(jlb.ints_to_planes(vals)))


def _jax_ntt_fast_matches(log_n, inverse):
    a, ja = _mont(1 << log_n, seed=log_n)
    got = N.ntt_fast(a, N.Domain(log_n, "cpu"), inverse=inverse)
    exp = dntt.ntt_fast(ja, log_n, inverse=inverse)
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))


def test_ntt_fast_matches_jax():
    _jax_ntt_fast_matches(6, False)


@pytest.mark.slow
@pytest.mark.parametrize("log_n,inverse", [(6, True), (9, False), (9, True)])
def test_ntt_fast_matches_jax_wide(log_n, inverse):
    _jax_ntt_fast_matches(log_n, inverse)


@pytest.mark.parametrize("log_n", [6, 9, K.CG_MAX_LOG + 1, K.CG_MAX_LOG + 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_fast_matches_base(log_n, inverse):
    """log_n above the kernel's cap runs the Bailey split (+2: a split
    whose second pass is 2^2 points)."""
    a, _ = _mont(1 << log_n, seed=60 + log_n)
    dom = N.Domain(log_n, "cpu")
    assert torch.equal(N.ntt_fast(a, dom, inverse), N.ntt(a, dom, inverse))


def test_cg_network_and_twiddles_match_jax():
    """The plain constant-geometry network and its twiddles equal the JAX
    package's `_cg_kernel_call` (rolled on the CPU) and `_cg_twiddles`."""
    log_m, cb = 3, 8
    m = 1 << log_m
    vals = sample(R, m * cb, seed=70)
    x = lb.ints_to_planes(vals).reshape(8, m, cb)
    jx = jlb.ints_to_planes(vals).reshape(16, m, cb)
    dom = N.Domain(log_m, "cpu")
    for inverse in (False, True):
        jtws = dntt._cg_twiddles(log_m, inverse)
        assert torch.equal(dom.cg_twiddles(log_m, inverse), convert.to_torch(
            np.asarray(jtws).transpose(1, 0, 2)).permute(1, 0, 2))
    tws = dom.cg_twiddles(log_m, False)
    got = K.cg_stages_plain(x, tws)
    exp = dntt._cg_kernel_call(jx, log_m, False)
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))
    # the wrapper's contract: the same network, natural order out, from
    # the table of w^0 .. w^(M/2-1)
    assert torch.equal(K.fr_cg_ntt(x, dom.ntt_twiddles(log_m, False)),
                       got[:, K.bitrev_perm(log_m)])


@pytest.mark.parametrize("cb", [1, 4])
def test_folded_pass_is_the_split_step(cb):
    """fr_cg_ntt with the split twiddles and cb > 0 equals the steps it
    folds: the pass, `fr_mont_mul` by the twiddles, the transpose."""
    log_m2, log_m1 = 3, 2
    m2, m1 = 1 << log_m2, 1 << log_m1
    vals = sample(R, m2 * m1 * cb, seed=71)
    x = lb.ints_to_planes(vals).reshape(8, m2, m1 * cb)
    dom = N.Domain(log_m2 + log_m1, "cpu")
    for inverse in (False, True):
        tw = dom.ntt_twiddles(log_m2, inverse)
        stw = dom.split_twiddles(log_m1, log_m2, inverse)         # [8, M1, M2]
        v = K.fr_cg_ntt(x, tw).reshape(8, m2, m1, cb)
        v = K.fr_mont_mul(v, dom.split_twiddles(log_m2, log_m1, inverse)[
            ..., None].expand(8, m2, m1, cb).contiguous())
        want = v.permute(0, 2, 1, 3).contiguous()                 # [8, M1, M2, CB]
        assert torch.equal(K.fr_cg_ntt(x, tw, stw, cb), want)
        with pytest.raises(ValueError):     # no transposed store unfolded
            K.fr_cg_ntt(x, tw, None, cb)


def test_split_is_two_passes(monkeypatch):
    """A transform of twice the kernel's cap is two fr_cg_ntt calls, the
    first with the split twiddles, and no fr_mont_mul or copy between
    (the cap lowered to 2^3 here, as 2^10 is on the card)."""
    monkeypatch.setattr(K, "CG_MAX_LOG", 3)
    calls = []
    real = K.fr_cg_ntt
    monkeypatch.setattr(K, "fr_cg_ntt", lambda *a: calls.append(
        ("fr_cg_ntt", a[0].shape, len(a) > 2)) or real(*a))
    monkeypatch.setattr(K, "fr_mont_mul", lambda *a: calls.append(
        ("fr_mont_mul",)) or K.fr_mont_mul_plain(*a))
    a, _ = _mont(1 << 6, seed=72)
    dom = N.Domain(6, "cpu")
    N.ntt_fast(a, dom)                  # the domain makes its tables once
    calls.clear()
    got = N.ntt_fast(a, dom)
    assert calls == [("fr_cg_ntt", (8, 8, 8), True),
                     ("fr_cg_ntt", (8, 8, 8), False)]
    assert torch.equal(got, N.ntt(a, dom))


def test_split_twiddles_match_jax():
    dom = N.Domain(5, "cpu")
    got = dom.split_twiddles(2, 3, True)
    exp = dntt._split_twiddles(2, 3, True)
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))


def test_fast_quotient_matches_base():
    log_n = K.CG_MAX_LOG + 1
    a, _ = _mont(1 << log_n, seed=21)
    b, _ = _mont(1 << log_n, seed=22)
    dom = N.Domain(log_n, "cpu")
    assert torch.equal(N.quotient_scalars(a, b, dom, "fast"),
                       N.quotient_scalars(a, b, dom, "base"))


@pytest.mark.slow
def test_fast_quotient_matches_jax():
    log_n = 9
    a, ja = _mont(1 << log_n, seed=23)
    b, jb = _mont(1 << log_n, seed=24)
    got = N.quotient_scalars(a, b, N.Domain(log_n, "cpu"), "fast")
    exp = dntt._quotient_scalars_impl(ja, jb, log_n, fast=True)
    assert torch.equal(got, convert.to_torch(np.asarray(exp)))


def test_ntt_mode_switch(monkeypatch):
    monkeypatch.delenv("ULTRAGROTH_NTT", raising=False)
    assert N.ntt_mode("cpu") == "base"
    assert N.ntt_mode(torch.device("cuda")) == "fast"
    for mode in ("fast", "base"):
        monkeypatch.setenv("ULTRAGROTH_NTT", mode)
        assert N.ntt_mode("cpu") == N.ntt_mode("cuda") == mode
        other = "base" if mode == "fast" else "fast"
        assert N.ntt_mode("cpu", other) == other       # the argument wins
    monkeypatch.setenv("ULTRAGROTH_NTT", "fastest")
    with pytest.raises(ValueError):
        N.ntt_mode("cpu")
    monkeypatch.delenv("ULTRAGROTH_NTT")
    a, _ = _mont(8, seed=25)
    with pytest.raises(ValueError):
        N.quotient_scalars(a, a, N.Domain(3, "cpu"), "fastest")
