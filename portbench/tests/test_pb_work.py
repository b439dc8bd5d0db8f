"""The work-count functions behind the roofline shares, against counts
made by hand."""
import pytest

from portbench import work
from portbench.reference.curve import R
from portbench.reference.field import Field


def test_nonzero_signed_digits_by_hand():
    F = Field(R)
    # c = 8: 1 -> one digit; 255 -> -1 and a carry of 1 into window 1;
    # 0 -> none; 128 -> 128 itself (the top of the digit range)
    assert work.nonzero_digits(F.tensor([1, 255, 0, 128]), 8) == 4
    assert work.nonzero_digits(F.tensor([255]), 8) == 2
    assert work.nonzero_digits(F.tensor([129]), 8) == 2    # -127 and 1
    # r - 1 at c = 13: every window of its recode
    digits = work.nonzero_digits(F.tensor([R - 1]), 13)
    assert 15 <= digits <= work.n_windows(13) == 20


def test_windows_by_hand():
    assert [work.window(n) for n in (100, 4096, 65536, 1 << 20, 1 << 22)] == \
        [8, 10, 13, 13, 16]
    assert work.n_windows(13) == 20 and work.n_windows(127) == 3
    # the top window at c = 13 holds bits 247..253: (r - 1) >> 247 = 96,
    # so buckets up to 97 and 4096 / 128 = 32 sub-lanes each
    assert work.split_factor(19, 13) == 32 and work.split_factor(0, 13) == 1


def test_reduce_work_by_hand():
    # 4 buckets, no sub-lanes: 2 + 2 folds, 2 banks, 2 adds + 2 doublings
    assert work.reduce_work(4, [1]) == (6, 2)
    # 2 buckets in 2 sub-lanes each: 2 pre-fold adds bank nothing, then
    # 1 fold, 1 bank, 1 add + 1 doubling
    assert work.reduce_work(4, [2]) == (4, 1)


def test_bounds_by_hand():
    n, c = 1 << 20, 13
    steps = 20 * n
    ops_s = steps * 10 * 264 / 16.75e12
    assert work.drain_bound_s("g1", steps, n, c) == pytest.approx(ops_s)
    g2 = work.drain_bound_s("g2", steps, n, c)
    assert g2 == pytest.approx(steps * (8 * 792 + 2 * 528) / 16.75e12)
    # a drain of almost no steps is bound by its bytes
    few = work.drain_bound_s("g1", 1, n, c)
    assert few == pytest.approx((n * 64 + 20 * n * 4 + 20 * 4096 * 140)
                                / 3.35e12)
