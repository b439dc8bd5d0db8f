"""PyTorch port on the card: each CUDA kernel against its plain version on
the same CUDA tensors, and a small prove on the card against the port's
CPU prove.  Marked `cuda`; skipped where no CUDA device is present.

Imports no JAX, so it runs where only the port is installed:
    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import curve_ops
from ultragroth_tpu_torch.ops.field import fq
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol.prover import TorchGroth16Prover
from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
from ultragroth_tpu_torch.testkit.setup import groth16_setup

pytestmark = pytest.mark.cuda
N = 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cu(t, dev):
    t = lb.narrow(t, torch.int32) if t.dtype == torch.int64 and t.dim() > 1 \
        else t.to(torch.int32)
    return t.to(dev).contiguous()


def _points(group, n):
    F = fq()
    rng = random.Random(61)
    if group == "g1":
        pts = [oc.g1_mul(oc.G1, rng.randrange(1, R)) for _ in range(n)]
        return torch.stack([F.to_mont(lb.ints_to_planes([p[0] for p in pts])),
                            F.to_mont(lb.ints_to_planes([p[1] for p in pts]))])
    pts = [oc.g2_mul(oc.G2, rng.randrange(1, R)) for _ in range(n)]
    c = [F.to_mont(lb.ints_to_planes([p[i][k] for p in pts]))
         for i in range(2) for k in range(2)]
    return torch.stack([torch.stack(c[:2]), torch.stack(c[2:])])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_kernels_match_plain_on_card(dev, group):
    ops = curve_ops(group)
    table = _points(group, 2 * N)
    no_inf = torch.zeros(N, dtype=torch.bool)
    acc = ops.dbl(ops.affine_to_xyzz(table[0][..., N:], table[1][..., N:], no_inf))
    q = ops.affine_to_xyzz(table[0][..., :N], table[1][..., :N], no_inf)
    acc[..., 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 1:3] = q[..., 1:3]
    orders = torch.arange(N) * 2 + (torch.arange(N) % 3 == 0).long()
    orders[1], orders[2] = 2, 5                       # P == Q, P == -Q
    gidx, stride = torch.arange(N), torch.ones(N, dtype=torch.long)
    cnt = (torch.arange(N) % 7 != 4).long()
    args = (table, orders, gidx, stride, cnt)
    cargs = [_cu(x, dev) for x in args]
    sticky = torch.zeros(1, dtype=torch.int32, device=dev)

    k, kf = K.curve_madd_fast(group, _cu(acc, dev), *cargs, 0, sticky=sticky)
    p, pf = K.curve_madd_fast_plain(group, acc, *args, 0)
    assert torch.equal(lb.widen(k.cpu()), p) and torch.equal(kf.cpu(), pf)
    assert int(sticky.item()) == 1
    k = K.curve_madd_signed(group, _cu(acc, dev), *cargs, 0)
    assert torch.equal(lb.widen(k.cpu()),
                       K.curve_madd_signed_plain(group, acc, *args, 0))
    b = torch.roll(acc, 1, -1)
    b[..., 5] = acc[..., 5]
    b[..., 6] = ops.neg(acc[..., 6:7])[..., 0]
    ok = torch.arange(N) % 5 != 2
    k = K.curve_add_where(group, _cu(acc, dev), _cu(b, dev), ok.to(dev))
    assert torch.equal(lb.widen(k.cpu()), K.curve_add_where_plain(group, acc, b, ok))
    h = acc[..., :20].contiguous()
    k = K.curve_horner_scale(group, _cu(h, dev), 13)
    assert torch.equal(lb.widen(k.cpu()), K.curve_horner_scale_plain(group, h, 13))


def test_fr_kernels_match_plain_on_card(dev):
    g = torch.Generator().manual_seed(62)
    a = torch.randint(0, 1 << 32, (8, 4 * N), generator=g, dtype=torch.int64)
    a[7] %= lb.int_to_limbs(R)[7]
    b = a.flip(1).contiguous()
    k = K.fr_mont_mul(_cu(a, dev), _cu(b, dev))
    assert torch.equal(lb.widen(k.cpu()), K.fr_mont_mul_plain(a, b))
    for half in (1, 16, 2 * N):
        tw = b[:, :half].contiguous()
        k = K.fr_butterfly(_cu(a, dev), _cu(tw, dev))
        assert torch.equal(lb.widen(k.cpu()), K.fr_butterfly_plain(a.clone(), tw))


def test_wrapper_refuses_cpu_dtype_on_card(dev):
    """On a CUDA tensor a wrapper launches or raises: no plain fallback."""
    a = torch.zeros(8, 4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        K.fr_mont_mul(a, a)


def test_small_prove_on_card_matches_cpu(dev):
    r1cs, w = square_chain_circuit(60, seed=3)
    setup = groth16_setup(r1cs, seed=9)
    zk = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    K.reset_launch_counts()
    on_card = TorchGroth16Prover(zk).prove(w, r=11, s=22)
    assert all(v > 0 for v in K.launch_counts().values())
    on_cpu = TorchGroth16Prover(zk, device="cpu").prove(w, r=11, s=22)
    assert on_card.to_json() == on_cpu.to_json()
