"""The port's kernel registry: the CUDA kernels (the curve ones in a G1
and a G2 instance), each with its plain PyTorch version beside it.

Twin of the JAX package's `ops/kernels.py`, which pairs each Pallas kernel
with its rolled formula.  Here every wrapper looks at where its tensors
live: on the CPU it runs the plain version of this module; on a CUDA
device it launches its kernel (`csrc/`, built by `_build.py`) on the
current stream, or raises — there is no fallback from the card to the
plain version.  Each wrapper adds one to its launch count where it
launches, and nowhere else.

Field mode.  Each kernel is built twice (`_build.MODES`): `cios` and
`mma`, the latter with its Montgomery products' reduction on the tensor
cores (`csrc/mma_field.cuh`, the twin of `ULTRAGROTH_MXU_FIELD`).  A
wrapper launches the build of the mode current on its thread
(`field_mode(...)`, default `cios`); a prover fixes its mode when it is
built and runs under it.  Launches are counted per kernel and mode; the
launches of MMA-built kernels are the launches of `mont_mul_mma`
(`ultragroth_tpu/ops/mxufield.py:88`).  On the CPU the mode changes
nothing, as in the JAX package, whose plain path never reaches
`mont_mul_mxu`.

Tensor contract (plane-major, see `limbs.py`):
  Fr element batch  [8, *batch]            xyzz G1 [4, 8, n], G2 [4, 2, 8, n]
  affine table G1   [2, 8, T], G2 [2, 2, 8, T]   (curve_fixed_base_mul's
                    window table; affine outputs (x, y) the same planes)
  MSM point table G1 [T, 2, 8], G2 [T, 2, 2, 8]  (point-major: the bucket
                    drain, curve_window_table and their plain versions,
                    `curve.table_from_planes`)
  on CUDA the limbs are int32 (u32 bit patterns), every index int32, every
  flag bool; everything contiguous.

The curve kernels' outputs are canonical (the lazy Fq reduction inside a
launch is canonicalised at exit), so a kernel's output equals its plain
version's exactly.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

from .curve import curve_ops, table_planes
from .field import fq, fr

KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces)
    "fr_mont_mul": ("ultragroth_tpu_torch/csrc/fr_kernels.cu",
                    "ultragroth_tpu/ops/kernels.py:22"),
    "fr_butterfly": ("ultragroth_tpu_torch/csrc/fr_kernels.cu",
                     "ultragroth_tpu/ops/kernels.py:32"),
    "fr_cg_ntt": ("ultragroth_tpu_torch/csrc/fr_kernels.cu",
                  "ultragroth_tpu/ops/ntt.py:196"),
}
for _g in ("g1", "g2"):
    KERNELS.update({
        f"{_g}_bucket_drain": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                               "ultragroth_tpu/ops/kernels.py:102"),
        f"{_g}_fixed_base_mul": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                                 "ultragroth_tpu/ops/kernels.py:64"),
        f"{_g}_add_where": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                            "ultragroth_tpu/ops/kernels.py:171"),
        f"{_g}_window_table": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                               "ultragroth_tpu/ops/kernels.py:171"),
        f"{_g}_bucket_reduce": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                                "ultragroth_tpu/ops/kernels.py:171"),
        f"{_g}_window_combine": (f"ultragroth_tpu_torch/csrc/{_g}_kernels.cu",
                                 "ultragroth_tpu/ops/kernels.py:133"),
    })

MMA_ROW = ("mont_mul_mma", "ultragroth_tpu_torch/csrc/mma_field.cuh",
           "ultragroth_tpu/ops/mxufield.py:88")
"""(name, source, replaced TPU kernel) of the MMA field's row: it runs
inside every kernel of the mma build."""
FIELD_MODES = ("cios", "mma")

_launches: collections.Counter = collections.Counter()   # (name, mode)
_mode = threading.local()


def current_field_mode() -> str:
    return getattr(_mode, "value", "cios")


@contextlib.contextmanager
def field_mode(mode: str):
    """Launch the `mode` build of every kernel on this thread inside."""
    if mode not in FIELD_MODES:
        raise ValueError(f"unknown field mode {mode!r}")
    prev = current_field_mode()
    _mode.value = mode
    try:
        yield
    finally:
        _mode.value = prev


def launch_counts(mode: str | None = None) -> dict:
    """Launches of each kernel since the last reset, in `mode` or in
    both."""
    modes = FIELD_MODES if mode is None else (mode,)
    return {name: sum(_launches[(name, m)] for m in modes)
            for name in KERNELS}


def reset_launch_counts() -> None:
    _launches.clear()


# -- launch plumbing ---------------------------------------------------------

def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {x.device}")


def _check(x: torch.Tensor, dtype: torch.dtype, shape=None, name="tensor"):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _launch(name: str, launcher: str, *args) -> None:
    from . import _build
    mode = current_field_mode()
    fn = _build.load(mode)[launcher]
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({mode}): CUDA launch failed with error "
                           f"{rc}")
    _launches[(name, mode)] += 1


def _elem_shape(group: str) -> tuple:
    return (8,) if group == "g1" else (2, 8)


# -- fr_mont_mul ---------------------------------------------------------------

def fr_mont_mul_plain(a, b):
    return fr().mont_mul(a, b)


def fr_mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery product a * b * R^-1, canonical.  a: [8, *batch];
    b: the same shape, or [8, 1, ...] broadcast over every lane.  Any
    a < 2^256 is accepted when b < r."""
    if not _on_cuda(a):
        return fr_mont_mul_plain(a, b)
    _check(a, torch.int32, name="a")
    _check(b, torch.int32, name="b")
    n = a.numel() // 8
    b_n = b.numel() // 8
    if a.shape[0] != 8 or b.shape[0] != 8 or b_n not in (1, n):
        raise ValueError(f"fr_mont_mul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(a)
    _launch("fr_mont_mul", "ug_fr_mont_mul", a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, b_n)
    return out


# -- fq_mont_mul (a probe of the field, no TPU kernel) ----------------------------

def fq_mont_mul_plain(a, b):
    return fq().mont_mul(a, b)


def fq_mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq Montgomery product a * b * R^-1, canonical, a and b [8, n]: the
    field of the curve kernels alone, for the checks of either field mode.
    Takes a < 2^256 with b < q, or a, b < 2q (the lazy values)."""
    if not _on_cuda(a):
        return fq_mont_mul_plain(a, b)
    n = a.shape[-1]
    _check(a, torch.int32, (8, n), "a")
    _check(b, torch.int32, (8, n), "b")
    out = torch.empty_like(a)
    _launch("fq_mont_mul", "ug_fq_mont_mul", a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n)
    return out


# -- fr_butterfly ----------------------------------------------------------------

def fr_butterfly_plain(a, tw):
    F = fr()
    half = tw.shape[1]
    v = a.view(8, -1, 2, half)
    u, w = v[:, :, 0, :], v[:, :, 1, :]
    t = F.mont_mul(w, tw[:, None, :])
    hi, lo = F.add(u, t), F.sub(u, t)
    v[:, :, 0, :] = hi
    v[:, :, 1, :] = lo
    return a


def fr_butterfly(a: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One DIT stage IN PLACE over a [8, n] Montgomery array: with h =
    tw.shape[1], pair (u, w) = (a[blk*2h + j], a[blk*2h + h + j]) becomes
    (u + w*tw[j], u - w*tw[j]).  The JAX kernel's (u, w, tw) -> (hi, lo)
    over gathered halves, applied to the array the NTT stage reads."""
    half = tw.shape[1]
    if a.dim() != 2 or a.shape[0] != 8 or a.shape[1] % (2 * half):
        raise ValueError(f"fr_butterfly: shapes {tuple(a.shape)}, "
                         f"{tuple(tw.shape)}")
    if not _on_cuda(a):
        return fr_butterfly_plain(a, tw)
    _check(a, torch.int32, name="a")
    _check(tw, torch.int32, (8, half), "tw")
    _launch("fr_butterfly", "ug_fr_butterfly", a.data_ptr(), tw.data_ptr(),
            a.shape[1], half)
    return a


# -- fr_cg_ntt -------------------------------------------------------------------

CG_MAX_LOG = 10
"""The longest column `fr_cg_ntt` takes, 2^10 points: 128 threads of 8
points, 32 KB of a block's exchange buffer (csrc/ntt.cuh).
`ops/ntt.py:_ntt_cols` splits larger transforms."""


def bitrev_perm(log_n: int) -> torch.Tensor:
    """[2^log_n] int64: the bit reversal of each index."""
    n = 1 << log_n
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def cg_exponents(log_m: int) -> list:
    """[log_m] int64 tensors [M/2]: stage s's twiddle of butterfly i is
    w^e[s][i], e = (sigma_s(i) mod 2^s) * (M >> (s + 1)), with sigma_0 =
    bitrev, sigma_(s+1)(2i) = sigma_s(i), sigma_(s+1)(2i+1) = sigma_s(i +
    M/2): the index bookkeeping of the constant-geometry schedule (the JAX
    package's `_cg_sigmas` / `_cg_twiddles`).  Every e < M/2."""
    m = 1 << log_m
    sig = bitrev_perm(log_m)
    out = []
    for s in range(log_m):
        out.append((sig[:m // 2] % (1 << s)) * (m >> (s + 1)))
        sig = torch.stack([sig[:m // 2], sig[m // 2:]], dim=1).reshape(m)
    return out


def cg_stages_plain(x, tws):
    """The constant-geometry (Pease) network along axis 1 of x [8, M, CB]
    Montgomery planes with twiddles tws [log_m, 8, M/2]; the output is in
    BIT-REVERSED layout (the JAX package's `_cg_stages`).  Stage s:
    out[2i] = a[i] + tw_s[i]*a[i + M/2], out[2i+1] = a[i] - tw_s[i]*a[i + M/2]."""
    F = fr()
    m = x.shape[1]
    for s in range(tws.shape[0]):
        u, w = x[:, :m // 2], x[:, m // 2:]
        t = F.mont_mul(w, tws[s][:, :, None])
        x = torch.stack([F.add(u, t), F.sub(u, t)], dim=2).reshape(x.shape)
    return x


def cg_ntt_products(log_m: int, cols: int, cb: int = 0) -> int:
    """Fr products an `fr_cg_ntt` call of `cols` columns of 2^log_m points
    needs (its bound counts these): each pass of radix R = 2^B (B = 3 but
    the last) twiddles R - 1 of every R points but those whose twiddles
    are all w^0 (1/Ns of them, Ns the earlier passes' span; the first
    pass's all) and runs an R-point DFT of 5 (R = 8), 1 (4) or 0 (2)
    products; with cb > 0 the folded split twiddle w^(k*j1), one a point
    but row j1 = 0 and output k = 0."""
    m, done, n = 1 << log_m, 0, 0
    while done < log_m:
        b = min(3, log_m - done)
        r, ns = 1 << b, 1 << done
        n += (r - 1) * (m // r) * (ns - 1) // ns + (m // r) * {8: 5, 4: 1, 2: 0}[r]
        done += b
    return n * cols + ((cols // cb - 1) * (m - 1) * cb if cb else 0)


def _cg_shapes(x, tw, stw, cb):
    """log_m of a valid fr_cg_ntt call, else ValueError."""
    m = x.shape[1] if x.dim() == 3 else 0
    log_m = m.bit_length() - 1
    if not 1 <= log_m <= CG_MAX_LOG or m != 1 << log_m:
        raise ValueError(f"fr_cg_ntt: {m} points per column; the kernel takes "
                         f"2^1 .. 2^{CG_MAX_LOG}")
    cols = x.shape[2]
    if (x.shape[0] != 8 or tuple(tw.shape) != (8, m // 2) or cb < 0
            or (stw is None) != (cb == 0) or (cb and (
                cols % cb or tuple(stw.shape) != (8, cols // cb, m)))):
        raise ValueError(f"fr_cg_ntt: shapes {tuple(x.shape)}, "
                         f"{tuple(tw.shape)}, "
                         f"{None if stw is None else tuple(stw.shape)}, cb {cb}")
    return log_m


def fr_cg_ntt_plain(x, tw, stw=None, cb: int = 0):
    """`fr_cg_ntt` by the constant-geometry network (its twiddles gathered
    from tw), the bit reversal, and for the split's first pass
    `fr_mont_mul_plain` by the split twiddles and a permute."""
    log_m = _cg_shapes(x, tw, stw, cb)
    tws = torch.stack([tw[:, e.to(tw.device)] for e in cg_exponents(log_m)])
    rev = bitrev_perm(log_m).to(x.device)
    y = cg_stages_plain(x, tws)[:, rev]
    if not cb:
        return y.contiguous()
    m, m1 = x.shape[1], x.shape[2] // cb
    y = fr_mont_mul_plain(y.reshape(8, m, m1, cb), stw.permute(
        0, 2, 1)[..., None].expand(8, m, m1, cb))
    return y.permute(0, 2, 1, 3).contiguous()


def fr_cg_ntt(x: torch.Tensor, tw: torch.Tensor, stw: torch.Tensor | None = None,
              cb: int = 0) -> torch.Tensor:
    """NTT of every column of x [8, M, C] (M = 2^log_m points along axis
    1, Montgomery planes, canonical; 1 <= log_m <= CG_MAX_LOG), natural
    order in and out, with w the primitive M-th root whose powers
    w^0 .. w^(M/2-1) tw [8, M/2] holds (its inverse for the inverse
    transform).  cb == 0 (stw None): the output is [8, M, C].  cb > 0
    (C = M1 * cb, stw [8, M1, M]): the Bailey split's first pass, each
    output k of input column j1*cb + b multiplied by stw[:, j1, k] and
    stored transposed, to [8, M1, M, cb] row j1."""
    log_m = _cg_shapes(x, tw, stw, cb)
    if not _on_cuda(x):
        return fr_cg_ntt_plain(x, tw, stw, cb)
    _check(x, torch.int32, name="x")
    _check(tw, torch.int32, name="tw")
    if cb:
        _check(stw, torch.int32, name="stw")
    m, cols = x.shape[1], x.shape[2]
    out = torch.empty((8, cols // cb, m, cb) if cb else x.shape,
                      dtype=x.dtype, device=x.device)
    _launch("fr_cg_ntt", "ug_fr_cg_ntt", x.data_ptr(), tw.data_ptr(),
            None if stw is None else stw.data_ptr(), out.data_ptr(), log_m,
            cols, cb)
    return out


# -- curve kernels ------------------------------------------------------------------

def gather_points_plain(group, table, orders, gidx, stride, cnt, t: int):
    """The bucket loop's per-step point fetch: lane i reads order entry
    gidx[i] + t*stride[i] (entry 0 past its count), entry = pid*2 + sign,
    and takes point pid of the point-major table, negated when sign is
    set.  Returns (qx, qy, valid)."""
    ops = curve_ops(group)
    valid = t < cnt
    pos = torch.where(valid, gidx.long() + t * stride.long(),
                      torch.zeros_like(gidx, dtype=torch.long))
    ent = orders.long()[pos]
    q = table_planes(table[ent >> 1])
    neg = (ent & 1) != 0
    return q[0], torch.where(neg, ops.F.neg(q[1]), q[1]), valid


def curve_madd_fast_plain(group, acc, table, orders, gidx, stride, cnt, t):
    """One step of the bucket loop's common case, the JAX package's
    `curve_madd_fast` with the gather: out = valid ? acc + (+-Q) : acc and
    flag = valid & (x-collision | acc at infinity), valid = t < cnt."""
    ops = curve_ops(group)
    qx, qy, valid = gather_points_plain(group, table, orders, gidx, stride,
                                        cnt, t)
    added, bad = ops.madd_fast(acc, qx, qy)
    return ops.select(valid, added, acc), bad & valid


def curve_madd_signed_plain(group, acc, table, orders, gidx, stride, cnt, t):
    """One complete step, the JAX package's `curve_madd_signed` with the
    gather: acc + (+-Q), Q at infinity where t >= cnt."""
    ops = curve_ops(group)
    qx, qy, valid = gather_points_plain(group, table, orders, gidx, stride,
                                        cnt, t)
    return ops.madd_unified(acc, qx, qy, ~valid)


DRAIN_ALL = (1 << 31) - 1
"""A `t_to` past every count: each lane drains to its own count."""


def curve_bucket_drain_plain(group, table, orders, gidx, stride, cnt,
                             t_from: int = 0, t_to: int = DRAIN_ALL,
                             acc=None):
    """Steps t_from .. min(t_to, cnt[i]) - 1 of every lane, one step at a
    time over the lanes that still run: the fast step, and the complete
    step where it flags."""
    ops = curve_ops(group)
    n = gidx.shape[0]
    acc = (ops.inf_xyzz((n,), table.device, table.dtype) if acc is None
           else acc.clone())
    stop = min(t_to, int(cnt.max())) if n else t_from
    for t in range(t_from, stop):
        run = torch.nonzero(cnt > t).squeeze(1)
        lanes = (orders, gidx[run], stride[run], cnt[run], t)
        a = acc[..., run]
        out, flag = curve_madd_fast_plain(group, a, table, *lanes)
        if bool(flag.any()):
            out = ops.select(flag, curve_madd_signed_plain(group, a, table,
                                                           *lanes), out)
        acc[..., run] = out
    return acc


def curve_bucket_drain(group: str, table, orders, gidx, stride, cnt,
                       t_from: int = 0, t_to: int = DRAIN_ALL, acc=None):
    """The bucket loop of the MSMs as ONE launch: lane i adds, for t in
    [t_from, min(t_to, cnt[i])), the point of order entry gidx[i] +
    t*stride[i] (entry = pid*2 + sign) of the point-major table [T, 2,
    *elem] to its xyzz accumulator: the incomplete `curve_madd_fast`
    step, redone by the complete `curve_madd_signed` step where it flags.
    acc: the accumulators at t_from, [4, *elem, n] (None: infinity).
    Returns the accumulators after the lanes' last steps, canonical."""
    if not 0 <= t_from <= t_to:
        raise ValueError(f"curve_bucket_drain: steps [{t_from}, {t_to})")
    if not _on_cuda(table):
        return curve_bucket_drain_plain(group, table, orders, gidx, stride,
                                        cnt, t_from, t_to, acc)
    n = gidx.shape[0]
    e = _elem_shape(group)
    _check(table, torch.int32, name="table")
    if tuple(table.shape[1:]) != (2, *e) or table.data_ptr() % 16:
        raise ValueError(f"table: shape {tuple(table.shape)} (16-byte "
                         "aligned point-major rows wanted)")
    _check(orders, torch.int32, name="orders")
    for nm, v in (("gidx", gidx), ("stride", stride), ("cnt", cnt)):
        _check(v, torch.int32, (n,), nm)
    if acc is not None:
        _check(acc, torch.int32, (4, *e, n), "acc")
    out = torch.empty((4, *e, n), dtype=torch.int32, device=table.device)
    if n == 0:
        return out
    if orders.numel() == 0:
        raise ValueError("curve_bucket_drain: no order entries")
    _launch(f"{group}_bucket_drain", f"ug_{group}_bucket_drain",
            None if acc is None else acc.data_ptr(), out.data_ptr(),
            table.data_ptr(), orders.data_ptr(), gidx.data_ptr(),
            stride.data_ptr(), cnt.data_ptr(), t_from, t_to, n)
    return out


def fixed_base_gather_plain(table, tinf, scalars, w: int):
    """Step w of the 8-bit windowed fixed-base multiplication: lane i takes
    byte w of its standard-form scalar, entry 256*w + byte of the 32 x 256
    window table.  Returns (qx, qy, q_inf)."""
    limb = scalars[w // 4].long() & 0xFFFFFFFF
    ent = 256 * w + ((limb >> (8 * (w % 4))) & 0xFF)
    q = table[..., ent]
    return q[0], q[1], tinf[ent]


def curve_madd_valid_plain(group, acc, table, tinf, scalars, w: int):
    ops = curve_ops(group)
    qx, qy, q_inf = fixed_base_gather_plain(table, tinf, scalars, w)
    return ops.madd_unified(acc, qx, qy, q_inf)


FB_WINDOWS = 32
"""The fixed-base ladder's windows: 8-bit digits of a 256-bit scalar."""


def _fb_shapes(group, table, tinf, scalars):
    e = _elem_shape(group)
    t = table.shape[-1]
    if (tuple(table.shape) != (2, *e, t) or t < 256 * FB_WINDOWS
            or tuple(tinf.shape) != (t,) or scalars.dim() != 2
            or scalars.shape[0] != 8):
        raise ValueError(f"curve_fixed_base_mul: table {tuple(table.shape)}, "
                         f"tinf {tuple(tinf.shape)}, scalars "
                         f"{tuple(scalars.shape)}")


def curve_fixed_base_mul_plain(group, table, tinf, scalars):
    """The FB_WINDOWS steps of `curve_madd_valid_plain` from infinity, then
    `CurveOps.to_affine`: the per-step path the ladder replaces."""
    _fb_shapes(group, table, tinf, scalars)
    ops = curve_ops(group)
    acc = ops.inf_xyzz((scalars.shape[1],), table.device, table.dtype)
    for w in range(FB_WINDOWS):
        acc = curve_madd_valid_plain(group, acc, table, tinf, scalars, w)
    return ops.to_affine(acc)


def curve_fixed_base_mul(group: str, table, tinf, scalars):
    """The 8-bit windowed fixed-base multiplication of every lane as ONE
    launch: scalars [8, n] standard form -> sum_w table[256*w + byte w of
    the scalar] as Montgomery affine (x, y, inf), x and y [*elem, n]
    canonical ((0, 0) at infinity).  table: the affine window table [2,
    *elem, T] (Montgomery, entry 256*w + d = d * 256^w * G, T >= 8192),
    tinf [T] its infinity flags.  Each lane runs its 32 steps with the
    accumulator in registers and the block ends in one batch inversion
    (csrc/chains.cuh)."""
    _fb_shapes(group, table, tinf, scalars)
    e = _elem_shape(group)
    n = scalars.shape[1]
    if n == 0:
        out = torch.zeros((2, *e, 0), dtype=table.dtype, device=table.device)
        return out[0], out[1], torch.zeros(0, dtype=torch.bool,
                                           device=table.device)
    if not _on_cuda(table):
        return curve_fixed_base_mul_plain(group, table, tinf, scalars)
    _check(table, torch.int32, name="table")
    _check(tinf, torch.bool, name="tinf")
    _check(scalars, torch.int32, (8, n), "scalars")
    if tinf.data_ptr() % 4:
        raise ValueError("curve_fixed_base_mul: tinf must be 4-byte aligned")
    out = torch.empty((2, *e, n), dtype=torch.int32, device=table.device)
    inf = torch.empty(n, dtype=torch.bool, device=table.device)
    _launch(f"{group}_fixed_base_mul", f"ug_{group}_fixed_base_mul",
            table.data_ptr(), tinf.data_ptr(), table.shape[-1],
            scalars.data_ptr(), out.data_ptr(), inf.data_ptr(), n)
    return out[0], out[1], inf


AFFINE_CHUNK = 1 << 20
"""Lanes per plain to-affine pass of `curve_window_table_plain`: its int64
partial products for 2^20 lanes stay within a few GB."""


def _wt_shapes(group, table, inf, c, out):
    e = _elem_shape(group)
    size = table.shape[0]
    if (tuple(table.shape) != (size, 2, *e) or size < 1 or c < 1
            or tuple(inf.shape) != (size,) or tuple(out.shape[1:]) != (2, *e)
            or out.shape[0] % size):
        raise ValueError(f"curve_window_table: table {tuple(table.shape)}, "
                         f"inf {tuple(inf.shape)}, out {tuple(out.shape)}, "
                         f"c = {c}")
    return size, out.shape[0] // size


def curve_window_table_plain(group, table, inf, c: int, out):
    """The doublings as `curve_add_where_plain(P, P)` steps and a plain
    to-affine of each window (in passes of AFFINE_CHUNK lanes): the path
    the window-table kernel replaces."""
    size, nw = _wt_shapes(group, table, inf, c, out)
    ops = curve_ops(group)
    base = table_planes(table)
    cur = ops.affine_to_xyzz(base[0], base[1], inf)
    for w in range(1, nw):
        for _ in range(c):
            cur = curve_add_where_plain(group, cur, cur)
        rows = out[w * size:(w + 1) * size]
        for a in range(0, size, AFFINE_CHUNK):
            x, y, _ = ops.to_affine(cur[..., a:a + AFFINE_CHUNK])
            rows[a:a + AFFINE_CHUNK, 0] = x.movedim(-1, 0)
            rows[a:a + AFFINE_CHUNK, 1] = y.movedim(-1, 0)
    return out


def curve_window_table(group: str, table, inf, c: int, out):
    """The fixed-base table's windows as ONE launch: row w * npad + i of
    the point-major out [nw * npad, 2, *elem] becomes affine 2^(c*w) P_i,
    (0, 0) at infinity, for w = 1 .. nw - 1, from table [npad, 2, *elem]
    (P_i, Montgomery affine; it may be out[:npad]) and inf [npad].  Each
    lane doubles its point c times a window in registers and each window
    ends in one batch inversion a block (csrc/chains.cuh).  Returns out."""
    size, nw = _wt_shapes(group, table, inf, c, out)
    if not _on_cuda(table):
        return curve_window_table_plain(group, table, inf, c, out)
    _check(table, torch.int32, name="table")
    _check(inf, torch.bool, name="inf")
    _check(out, torch.int32, name="out")
    if table.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("curve_window_table: rows must be 16-byte aligned")
    if nw > 1:
        _launch(f"{group}_window_table", f"ug_{group}_window_table",
                table.data_ptr(), inf.data_ptr(), out.data_ptr(), size, c, nw)
    return out


def curve_add_where_plain(group, a, b, ok=None):
    ops = curve_ops(group)
    s = ops.add_unified(a, b)
    return s if ok is None else ops.select(ok, s, a)


def curve_add_where(group: str, a, b, ok=None):
    """ok ? a + b : a, complete xyzz add (doubles where a == b);
    ok=None adds on every lane."""
    if not _on_cuda(a):
        return curve_add_where_plain(group, a, b, ok)
    n = a.shape[-1]
    e = _elem_shape(group)
    _check(a, torch.int32, (4, *e, n), "a")
    _check(b, torch.int32, (4, *e, n), "b")
    if ok is not None:
        _check(ok, torch.bool, (n,), "ok")
    out = torch.empty_like(a)
    _launch(f"{group}_add_where", f"ug_{group}_add_where", a.data_ptr(),
            b.data_ptr(), None if ok is None else ok.data_ptr(),
            out.data_ptr(), n)
    return out


# -- the MSM's bucket reduction and window combine -------------------------

REDUCE_TAIL_WIDTH = 16
"""The width at which `curve_bucket_reduce` hands a window to its tail
block (csrc/reduce.cuh): wider levels are one launch each over every
window, the rest of a window's levels and its Horner run in one block."""


def reduce_plan(m: int, splits):
    """The launches of `curve_bucket_reduce` over W = len(splits) windows
    of m buckets.  Windows with equal consecutive splits form a group
    (w0, wg, split), whose state is `arrays` arrays [array][window][lane]
    of the current width: the current sums, then the banks.

    Returns (steps, tail, u, capacity): steps[k] the segments (in_off,
    out_off, n, neg_off, n_neg) of wide level k (lanes of the step's
    input and output planes; the first step reads the accumulators
    [W, m], the others a scratch of `capacity` lanes); tail the groups
    (state lane, windows, first window, arrays, pre-folds left) of the
    tail launch at width u."""
    runs = []
    for w, s in enumerate(splits):
        if runs and runs[-1][2] == s:
            runs[-1][1] += 1
        else:
            runs.append([w, 1, s])
    u_tail = min(m, REDUCE_TAIL_WIDTH)
    groups = [dict(off=w0 * m, wg=wg, arrays=1, pre=s.bit_length() - 1)
              for w0, wg, s in runs]
    steps, cap, u = [], 0, m
    while u > u_tail:
        segs, off = [], 0
        for g in groups:
            h = u // 2
            n = g["arrays"] * g["wg"] * h
            bank = g["pre"] == 0
            n_neg = g["wg"] * h if bank else 0
            segs.append((g["off"], off, n, off + n, n_neg))
            g["off"] = off
            off += n + n_neg
            if bank:
                g["arrays"] += 1
            else:
                g["pre"] -= 1
        steps.append(segs)
        cap = max(cap, off)
        u //= 2
    tail = [(g["off"], g["wg"], w0, g["arrays"], g["pre"])
            for g, (w0, _, _) in zip(groups, runs)]
    return steps, tail, u_tail, cap


def bucket_reduce_launches(m: int) -> int:
    """Launches of one `curve_bucket_reduce` over m buckets a window: one
    a wide level, then the tail."""
    return max(0, m.bit_length() - REDUCE_TAIL_WIDTH.bit_length()) + 1


def _check_splits(acc, splits):
    w, m = acc.shape[-2:]
    if m < 1 or m & (m - 1) or len(splits) != w or any(
            s < 1 or s & (s - 1) or s > m for s in splits):
        raise ValueError(f"curve_bucket_reduce: {m} buckets, splits "
                         f"{list(splits)} for {w} windows")


def curve_bucket_reduce_plain(group, acc, splits):
    """Each window's sum_i (i+1) B_i of the bucket sums acc [4, *elem, W,
    m] whose window w holds splits[w] sub-lanes a bucket (lane i*split + j
    of bucket i): log2(split) pairwise pre-folds, then levels folding the
    current sums and every bank pairwise and banking the negated even
    half of the current sums, S'(V) = 2 S'(E + O) - sum(E), and at width
    1 the Horner total = 2 total + bank over the banks, last first.
    Returns [4, *elem, W]."""
    _check_splits(acc, splits)
    ops = curve_ops(group)
    add = lambda a, b: curve_add_where_plain(group, a, b)
    out = [None] * acc.shape[-2]
    w0 = 0
    while w0 < len(splits):
        wg = 1
        while w0 + wg < len(splits) and splits[w0 + wg] == splits[w0]:
            wg += 1
        arrays = [acc[..., w0:w0 + wg, :]]
        pre = splits[w0].bit_length() - 1
        while arrays[0].shape[-1] > 1:
            folded = [add(x[..., 0::2], x[..., 1::2]) for x in arrays]
            if pre:
                pre -= 1
            else:
                folded.append(ops.neg(arrays[0][..., 0::2]))
            arrays = folded
        total = arrays[0][..., 0]
        for bank in reversed(arrays[1:]):
            total = add(add(total, total), bank[..., 0])
        for i in range(wg):
            out[w0 + i] = total[..., i]
        w0 += wg
    return torch.stack(out, dim=-1)


_plans: dict = {}


def _reduce_plan_on(dev, m: int, splits):
    """reduce_plan on dev, made once for each shape: (its segments, then
    its tail groups, as one int64 tensor; segments a step; adds a step;
    tail groups; tail width; scratch lanes; most arrays a tail window)."""
    key = (str(dev), m, tuple(splits))
    if key not in _plans:
        steps, tail, u, cap = reduce_plan(m, splits)
        rows = [r for segs in steps for r in segs] + tail
        _plans[key] = (torch.tensor(rows, dtype=torch.int64, device=dev),
                       [len(segs) for segs in steps],
                       [sum(r[2] for r in segs) for segs in steps],
                       len(tail), u, cap, max(g[3] for g in tail))
    return _plans[key]


def curve_bucket_reduce(group: str, acc, splits):
    """The bucket reduction of an MSM as `bucket_reduce_launches(m)`
    launches: acc [4, *elem, W, m] the drain's sub-lane sums (m a power of
    two; window w in splits[w] sub-lanes a bucket) -> each window's
    sum_i (i+1) B_i [4, *elem, W], canonical: the very adds of
    `curve_bucket_reduce_plain`, in its order."""
    _check_splits(acc, splits)
    if not _on_cuda(acc):
        return curve_bucket_reduce_plain(group, acc, splits)
    e = _elem_shape(group)
    w, m = acc.shape[-2:]
    _check(acc, torch.int32, (4, *e, w, m), "acc")
    desc, nsegs, nadds, ngroups, u, cap, arrays = _reduce_plan_on(
        acc.device, m, splits)
    bufs = [torch.empty((4, *e, cap), dtype=torch.int32, device=acc.device)
            for _ in range(min(2, len(nsegs)))]
    src, src_n, row = acc, w * m, 0
    for k, (nseg, n) in enumerate(zip(nsegs, nadds)):
        dst = bufs[k % 2]
        _launch(f"{group}_bucket_reduce", f"ug_{group}_reduce_step",
                src.data_ptr(), src_n, dst.data_ptr(), cap,
                desc.data_ptr() + 40 * row, nseg, n)
        src, src_n, row = dst, cap, row + nseg
    out = torch.empty((4, *e, w), dtype=torch.int32, device=acc.device)
    _launch(f"{group}_bucket_reduce", f"ug_{group}_reduce_tail",
            src.data_ptr(), src_n, desc.data_ptr() + 40 * row, ngroups, w, u,
            arrays, out.data_ptr(), w)
    return out


def curve_horner_scale_plain(group, pts, c: int):
    """Lane w of the window sums [4, *elem, W] doubled c*w times."""
    ops = curve_ops(group)
    n = pts.shape[-1]
    lane = torch.arange(n, device=pts.device)
    for i in range(c * (n - 1)):
        pts = ops.select(i < c * lane, ops.dbl(pts), pts)
    return pts


COMBINE_MAX_WINDOWS = 128


def curve_window_combine_plain(group, pts, c: int):
    """sum_w 2^(c*w) S_w of the window sums pts [4, *elem, W]: window w
    doubled c*w times, padded with infinity to m = 2^k >= max(W, 2), then
    folded pairwise.  Returns the xyzz point [4, *elem]."""
    ops = curve_ops(group)
    w = pts.shape[-1]
    m = 1 << max(1, (w - 1).bit_length())
    total = torch.cat([curve_horner_scale_plain(group, pts, c),
                       ops.inf_xyzz((m - w,), pts.device, pts.dtype)], -1)
    while m > 1:
        total = curve_add_where_plain(group, total[..., 0::2],
                                      total[..., 1::2])
        m //= 2
    return total[..., 0]


def curve_window_combine(group: str, pts, c: int):
    """The window combine of an MSM as ONE launch: pts [4, *elem, W]
    window sums (W <= COMBINE_MAX_WINDOWS) -> sum_w 2^(c*w) S_w, the
    xyzz point [4, *elem], canonical; the doublings and adds of
    `curve_window_combine_plain`, in its order.  The launch's blocks
    write the scaled windows to a scratch and count themselves done in
    an int the wrapper zeroes; the last one folds."""
    n = pts.shape[-1]
    if not 1 <= n <= COMBINE_MAX_WINDOWS or c < 1:
        raise ValueError(f"curve_window_combine: {n} windows (1 .. "
                         f"{COMBINE_MAX_WINDOWS}), c = {c}")
    if not _on_cuda(pts):
        return curve_window_combine_plain(group, pts, c)
    e = _elem_shape(group)
    _check(pts, torch.int32, (4, *e, n), "pts")
    m = 1 << max(1, (n - 1).bit_length())
    scaled = torch.empty((4, *e, m), dtype=torch.int32, device=pts.device)
    counter = torch.zeros(1, dtype=torch.int32, device=pts.device)
    out = torch.empty((4, *e, 1), dtype=torch.int32, device=pts.device)
    _launch(f"{group}_window_combine", f"ug_{group}_window_combine",
            pts.data_ptr(), n, c, scaled.data_ptr(), counter.data_ptr(),
            out.data_ptr())
    return out[..., 0]


# -- the Fq product's latency (a probe, no TPU kernel) ----------------------

def fq_mul_chain_plain(a, b, steps: int):
    F = fq()
    for _ in range(steps):
        a = F.mont_mul(a, b)
    return a


def fq_mul_chain(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """Lane i: a_i multiplied by b_i `steps` times, each product waiting
    for the last (a, b [8, n], canonical); one warp of lanes a launch
    block, so its time over `steps` is one Fq product's latency."""
    if not _on_cuda(a):
        return fq_mul_chain_plain(a, b, steps)
    n = a.shape[-1]
    _check(a, torch.int32, (8, n), "a")
    _check(b, torch.int32, (8, n), "b")
    out = torch.empty_like(a)
    _launch("fq_chain", "ug_fq_chain", a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, steps)
    return out
