"""Multi-scalar multiplication (Pippenger), G1 and G2.

The twin of the JAX package's `ops/msm.py:76-530` (`msm_g1`, `msm_g2` and
their stages), same algorithm and same stage contracts:

  1. signed digits: windowed-NAF recode, bucket = |d|, sign = d < 0, so
     2^(c-1) buckets per window; a spare window takes the last carry when
     254 % c == 0;
  2. bucket accumulation for ALL windows and buckets at once: points sorted
     by bucket (`torch.sort(stable=True)` with pid*2+sign carried as the
     value), skewed top windows split into sub-lanes (`_split_factor`), and
     every (window, bucket) lane drains its points in ONE
     `curve_bucket_drain` launch that gathers its own points from the
     point-major table;
  3. bucket reduction sum_i (i+1) B_i by binary decomposition
     (`curve_bucket_reduce`: one launch a wide level over every window,
     then one tail launch);
  4. window combine: window w doubled c*w times, then a log2(W) pairwise
     fold (`curve_window_combine`, one launch).

Host loops and kernels replace the JAX control flow:
  * the bucket loop's `lax.while_loop` over steps, its sticky-flag
    `lax.cond` redo and its two phases (all lanes to the kb-th largest
    count, then the kb heaviest lanes, merged) become one drain launch in
    which each lane loops to its own count and redoes an exceptional step
    alone with the complete add; it reads nothing back to the host, and
    each lane ends with the coordinates of the JAX drain's lane;
  * `lax.sort(num_keys=1)` becomes `torch.sort(stable=True)`;
  * the width-ladder padding of `_add_all` and the power-of-two padding of
    `_pad_pow2` only shared compiled shapes, and are dropped.

Kernel outputs are canonical, so the reduction's negation is the plain
canonical one and the result needs no final canonicalisation.  `msm` runs
under `torch.inference_mode()`: no autograd bookkeeping on the many small
tensor ops of the host loop.

Scalars are STANDARD-form Fr [8, N] and must be canonical (< r):
`_split_factor` sizes the top windows' lanes from r, and a larger scalar
would silently drop points, so `msm` checks and raises.  Points are
Montgomery-form affine point-major tables [N, 2, *elem]
(`curve.table_from_planes`) with an infinity mask [N].
"""
from __future__ import annotations

import torch

from ..constants import FR_MODULUS
from . import kernels
from .curve import curve_ops
from .limbs import int_to_limbs, widen

SCALAR_BITS = 254          # BN254 r bit length


def default_window(n: int) -> int:
    """Pippenger window size (same table as the JAX package)."""
    if n >= (1 << 22):
        return 16
    if n >= (1 << 16):
        return 13
    if n >= (1 << 12):
        return 10
    return 8


def n_windows_for(c: int) -> int:
    w = -(-SCALAR_BITS // c)
    return w + 1 if SCALAR_BITS % c == 0 else w


def _split_factor(w: int, c: int) -> int:
    """Static sub-accumulator split for window w: window w's signed bucket
    index is <= (r-1) >> (c*w) (+1 with the recode carry), so give each
    index 2^(c-1) / next_pow2(top+2) lanes and per-lane counts stay
    ~2N/2^c.  Load-bearing: scalars must be canonical (< r)."""
    n_buckets = 1 << (c - 1)
    top = (FR_MODULUS - 1) >> (c * w)
    if top + 1 >= n_buckets:
        return 1
    return max(1, n_buckets // (1 << (top + 1).bit_length()))


def _scalars_below_r(s64: torch.Tensor) -> torch.Tensor:
    """[8, N] int64 limbs -> bool: every scalar < r (lexicographic from the
    top limb)."""
    r = int_to_limbs(FR_MODULUS)
    lt = torch.zeros(s64.shape[1], dtype=torch.bool, device=s64.device)
    eq = torch.ones_like(lt)
    for j in range(7, -1, -1):
        lt |= eq & (s64[j] < r[j])
        eq &= s64[j] == r[j]
    return lt.all()


def _signed_digits(s64: torch.Tensor, c: int, n_windows: int):
    """Windowed-NAF recode: d + carry_in = d' + 2^c carry_out with
    d' in [-(2^(c-1) - 1), 2^(c-1)].  Returns (bucket |d'|, neg d' < 0),
    both [W, N].  The top window never carries out."""
    half = 1 << (c - 1)
    mask = (1 << c) - 1
    buckets, negs = [], []
    carry = torch.zeros_like(s64[0])
    for w in range(n_windows):
        bit0 = w * c
        limb, off = divmod(bit0, 32)
        d = s64[limb] >> off if limb < 8 else torch.zeros_like(s64[0])
        if off + c > 32 and limb + 1 < 8:
            d = d | (s64[limb + 1] << (32 - off))
        d = (d & mask) + carry
        neg = d > half
        buckets.append(torch.where(neg, (1 << c) - d, d))
        negs.append(neg)
        carry = neg.long()
    return torch.stack(buckets), torch.stack(negs)


def _drain_lanes(n: int, counts, c: int, splits, width: int | None = None):
    """The drain's lanes for all windows: sub-lane j of bucket d of window
    w reads order entries w*n + offset(d) + j, + split, ... (gidx,
    stride, cnt, int32 [W * width]; width: lanes a window, 2^(c-1) by
    default, the top windows' few buckets in splits[w] sub-lanes each).
    counts [W, 2^(c-1)]."""
    dev = counts.device
    n_buckets = 1 << (c - 1)
    width = n_buckets if width is None else width
    n_windows = counts.shape[0]
    counts = counts.long()
    offsets = torch.cat([torch.zeros((n_windows, 1), dtype=torch.long,
                                     device=dev),
                         torch.cumsum(counts, 1)[:, :-1]], 1)
    lane = torch.arange(width, device=dev)[None, :]
    split_w = torch.tensor(splits, device=dev)[:, None]
    d = lane // split_w
    j = lane % split_w
    base = offsets.gather(1, d) + j
    cnt = counts.gather(1, d)
    cnt = torch.clamp(cnt - j + split_w - 1, min=0) // split_w
    w_off = (torch.arange(n_windows, device=dev) * n)[:, None]
    gidx = (w_off + base).reshape(-1).to(torch.int32).contiguous()
    stride = split_w.expand(-1, width).reshape(-1).to(torch.int32).contiguous()
    return gidx, stride, cnt.reshape(-1).to(torch.int32).contiguous()


def _drain(group: str, table, orders, lanes):
    """Bucket accumulation for all windows (the JAX package's
    `_bucket_accumulate_all`) as ONE drain launch over the lanes'
    (`_drain_lanes`): orders [W, N] int32 entries pid*2+sign.  Returns the
    xyzz sub-lane sums [4, *elem, W, lanes a window]."""
    acc = kernels.curve_bucket_drain(
        group, table, orders.reshape(-1).contiguous(), *lanes)
    return acc.reshape(acc.shape[:-1] + (orders.shape[0], -1))


def _sort_buckets(buckets, negs, inf, c: int, pids):
    """Signed digits [W, N] sorted by bucket: (orders [W, N] int32
    entries pid*2 + sign, stable within a bucket; counts [W, 2^(c-1)]).
    pids [W, N]: the table row each (window, point) pair reads."""
    n_windows = buckets.shape[0]
    n_buckets = 1 << (c - 1)
    # bucket b >= 1 -> index b-1; bucket 0 and infinity points -> sentinel
    # n_buckets, which sorts last and is left out of the counts
    idx = torch.where(buckets > 0, buckets - 1, n_buckets)
    idx = torch.where(inf[None, :], n_buckets, idx)
    enc = pids * 2 + negs.long()
    _, perm = torch.sort(idx, dim=1, stable=True)
    orders = enc.gather(1, perm).to(torch.int32)
    w_base = (torch.arange(n_windows, device=idx.device)
              * (n_buckets + 1))[:, None]
    counts = torch.bincount((idx + w_base).reshape(-1),
                            minlength=n_windows * (n_buckets + 1))
    return orders, counts.reshape(n_windows, n_buckets + 1)[:, :n_buckets]


def msm_stages(group: str, table: torch.Tensor, inf: torch.Tensor,
               scalars: torch.Tensor, c: int):
    """`msm`'s work as a generator: yields (stage, its output) after each
    stage is enqueued (readback, digits, sort_bincount, index_math, drain,
    reduce, combine), the last output the MSM's point.  A caller that
    times the stages synchronises between them; `msm` runs them back to
    back.  N > 0 (see `msm`)."""
    dev = table.device
    n = table.shape[0]
    s64 = widen(scalars)
    if not bool(_scalars_below_r(s64)):
        raise ValueError("msm: scalars must be canonical (< r)")
    yield "readback", s64
    n_windows = n_windows_for(c)
    splits = [_split_factor(w, c) for w in range(n_windows)]
    digits = _signed_digits(s64, c, n_windows)
    yield "digits", digits
    orders, counts = _sort_buckets(
        *digits, inf.to(dev), c,
        torch.arange(n, device=dev)[None, :].expand(n_windows, n))
    yield "sort_bincount", (orders, counts)
    lanes = _drain_lanes(n, counts, c, splits)
    yield "index_math", lanes
    acc = _drain(group, table.contiguous(), orders, lanes)
    yield "drain", acc
    wsums = kernels.curve_bucket_reduce(group, acc, splits)
    yield "reduce", wsums
    yield "combine", kernels.curve_window_combine(group, wsums, c)


@torch.inference_mode()
def msm(group: str, table: torch.Tensor, inf: torch.Tensor,
        scalars: torch.Tensor, c: int) -> torch.Tensor:
    """sum_i scalars[i] * P_i as ONE xyzz point [4, *elem].

    table: [N, 2, *elem] point-major Montgomery affine (x, y); inf: [N]
    bool; scalars: [8, N] standard-form Fr planes, each < r (checked)."""
    ops = curve_ops(group)
    n = table.shape[0]
    if scalars.shape != (8, n) or inf.shape != (n,):
        raise ValueError(f"msm: table {tuple(table.shape)}, inf "
                         f"{tuple(inf.shape)}, scalars {tuple(scalars.shape)}")
    if n == 0:      # the drain's masked steps read order entry 0
        return ops.inf_xyzz((1,), table.device, table.dtype)[..., 0]
    for _, out in msm_stages(group, table, inf, scalars, c):
        pass
    return out


def msm_g1(table, inf, scalars, c: int = 16):
    """G1 MSM: table [N, 2, 8]; returns xyzz [4, 8]."""
    return msm("g1", table, inf, scalars, c)


def msm_g2(table, inf, scalars, c: int = 16):
    """G2 MSM: table [N, 2, 2, 8]; returns xyzz [4, 2, 8]."""
    return msm("g2", table, inf, scalars, c)


# -- fixed-base MSM (precomputed window multiples) ----------------------------
#
# The twin of the JAX package's `ops/msm.py:520-698`.  The prover's points
# are per-circuit constants, so a long-lived prover can precompute
# 2^(c*w) * P_i for every window w:
#
#   sum_i k_i P_i = sum_{w,i} d_{w,i} * (2^(c*w) P_i)
#
# and every window's digits then index the same buckets: all W windows'
# (point, digit) entries are sorted as ONE row, so the drain sums each
# bucket across the windows with the mixed adds it already does, with no
# window fold and no Horner combine, and the window can be larger (c ~
# log2(N) - 2) because only one bucket reduction remains.

FIXED_SPLIT = 2
"""Sub-lanes a bucket of the fixed-base MSM's merged row: the drain's
2^(c-1) * FIXED_SPLIT lanes each add ~W N / 2^(c-1) / FIXED_SPLIT points,
and the reduction pre-folds them.  Measured at c = 17 over 2^20 points
(`tools/torch_mma_variants.py --fixed`, one NVIDIA H100 80GB HBM3 at
700 W), drain + reduce in ms, G1 / G2: 1 sub-lane 10.14 / 22.01, 2 8.57
/ 22.16, 4 8.40 / 22.82, 8 8.40 / 24.72 (the per-window path with its
window folds: 13.42 / 36.58).  One lane a bucket leaves the G1 drain
1.3 waves deep; 2 is within 2 % of the best in both groups."""


def fixed_n_windows(c: int) -> int:
    nw = -(-SCALAR_BITS // c)
    if SCALAR_BITS % c == 0:
        nw += 1      # spare window absorbs the signed-recode carry
    return nw


def default_fixed_window(n: int) -> int:
    """Balance accumulation pairs (N * ceil(254/c)) against the one
    reduction over 2^(c-1) buckets: c ~ log2(N) - 2 (the JAX package's
    table)."""
    if n >= (1 << 21):
        return 19
    if n >= (1 << 19):
        return 17
    if n >= (1 << 15):
        return 16
    if n >= (1 << 12):
        return 13
    return 10


@torch.inference_mode()
def msm_fixed_table(group: str, table: torch.Tensor, inf: torch.Tensor,
                    c: int | None = None):
    """The fixed-base table of one point set (once per circuit).

    table [N, 2, *elem] point-major Montgomery affine, inf [N].  N is
    padded to a power of two >= 64 (padding points at infinity).  Returns
    (table [W * Npad, 2, *elem] whose row w * Npad + i is affine
    2^(c*w) * P_i, inf [Npad], c).  Windows 1 .. W - 1 are ONE
    `curve_window_table` launch: each lane doubles its point c times a
    window in registers, and each window's rows go to affine inside the
    kernel, straight into the table.  Memory: W * Npad * 64 B for G1, 128
    B for G2, one copy."""
    n = inf.shape[0]
    if table.shape[0] != n:
        raise ValueError(f"msm_fixed_table: table {tuple(table.shape)}, inf "
                         f"{tuple(inf.shape)}")
    if c is None:
        c = default_fixed_window(n)
    size = max(64, 1 << (n - 1).bit_length())
    dev = table.device
    inf = torch.cat([inf.to(dev), torch.ones(size - n, dtype=torch.bool,
                                             device=dev)])
    nw = fixed_n_windows(c)
    out = torch.zeros((nw * size,) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=dev)
    out[:n] = table
    out[:size][inf] = 0                                   # inf -> (0, 0)
    kernels.curve_window_table(group, out[:size], inf, c, out)
    return out, inf, c


def msm_fixed_stages(group: str, table: torch.Tensor, inf: torch.Tensor,
                     scalars: torch.Tensor, c: int):
    """`msm_fixed`'s work as a generator, as `msm_stages`: yields (stage,
    its output) after each stage is enqueued (readback, digits,
    sort_bincount, index_math, drain, reduce), the last output the MSM's
    point.  Arguments checked by `msm_fixed`; n > 0.

    The W windows' digits [W, Npad] are one row [1, W * Npad] whose entry
    w * Npad + i reads table row w * Npad + i, with the infinity mask
    repeated W times; one stable sort and one bincount over 2^(c-1)
    buckets; one drain of `FIXED_SPLIT` sub-lanes a bucket; one reduction
    that pre-folds the sub-lanes."""
    split = FIXED_SPLIT
    dev = table.device
    size = inf.shape[0]
    nw = fixed_n_windows(c)
    s64 = widen(scalars)
    if not bool(_scalars_below_r(s64)):
        raise ValueError("msm_fixed: scalars must be canonical (< r)")
    n = s64.shape[1]
    if n < size:
        s64 = torch.cat([s64, torch.zeros((8, size - n), dtype=s64.dtype,
                                          device=s64.device)], dim=1)
    yield "readback", s64
    buckets, negs = _signed_digits(s64, c, nw)
    digits = (buckets.reshape(1, -1), negs.reshape(1, -1))
    yield "digits", digits
    orders, counts = _sort_buckets(
        *digits, inf.to(dev).repeat(nw), c,
        torch.arange(nw * size, device=dev)[None, :])
    yield "sort_bincount", (orders, counts)
    lanes = _drain_lanes(nw * size, counts, c, [split], split << (c - 1))
    yield "index_math", lanes
    acc = _drain(group, table, orders, lanes)
    yield "drain", acc
    yield "reduce", kernels.curve_bucket_reduce(group, acc, [split])[..., 0]


@torch.inference_mode()
def msm_fixed(group: str, table: torch.Tensor, inf: torch.Tensor,
              scalars: torch.Tensor, c: int) -> torch.Tensor:
    """sum_i scalars[i] * P_i over a fixed-base table (`msm_fixed_table`)
    as ONE xyzz point [4, *elem].  scalars [8, n] standard-form Fr, n <=
    Npad (zero-padded), each < r (checked).

    The JAX package sorts and counts per window row and folds the
    windows' buckets (`ops/msm.py:628-657`); here every window's entries
    are one row (`msm_fixed_stages`), so one drain sums each bucket over
    all windows and one reduction follows, with no fold."""
    ops = curve_ops(group)
    size = inf.shape[0]
    nw = fixed_n_windows(c)
    n = scalars.shape[-1]
    if (scalars.shape[0] != 8 or n > size
            or table.shape[0] != nw * size):
        raise ValueError(f"msm_fixed: table {tuple(table.shape)}, inf "
                         f"{tuple(inf.shape)}, scalars {tuple(scalars.shape)}"
                         f", c = {c}")
    if n == 0:
        return ops.inf_xyzz((1,), table.device, table.dtype)[..., 0]
    for _, out in msm_fixed_stages(group, table, inf, scalars, c):
        pass
    return out
