"""PyTorch port on the card: each CUDA kernel against its plain version on
the same inputs, and small Groth16 and UltraGroth proves on the card
against the port's CPU proves (also in the mma field mode, over fixed-base
tables, and through the proof server with /cancel).  Marked `cuda`;
skipped where no CUDA device is present.

Imports no JAX, so it runs where only the port is installed:
    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.wtns import parse_wtns
from ultragroth_tpu_torch.io.zkey import (parse_groth16_zkey,
                                          parse_ultragroth_zkey)
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import curve_ops, table_from_planes
from ultragroth_tpu_torch.ops.field import fq
from ultragroth_tpu_torch.ops.ntt import Domain
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol import ultragroth as ug
from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                 TorchUltraGrothProver)
from ultragroth_tpu_torch.testkit.circuits import (LookupCircuit,
                                                  square_chain_circuit)
from ultragroth_tpu_torch.testkit.dsetup import _fb_table
from ultragroth_tpu_torch.testkit.setup import groth16_setup, ultragroth_setup

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
    """The bucket drain in both builds (6 steps over a 512-point table with
    P + P, P + (-P), +Q / -Q alternating and lanes past their counts, from
    given accumulators and from infinity), add_where and the window
    combine (whose doublings are curve_horner_scale's)."""
    ops = curve_ops(group)
    planes = _points(group, 2 * N)
    table = table_from_planes(planes)
    no_inf = torch.zeros(N, dtype=torch.bool)
    acc = ops.dbl(ops.affine_to_xyzz(planes[0][..., N:], planes[1][..., N:],
                                     no_inf))
    q = ops.affine_to_xyzz(planes[0][..., :N], planes[1][..., :N], no_inf)
    acc[..., 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 1:3] = q[..., 1:3]
    steps = 6
    g = torch.Generator().manual_seed(65)
    orders = torch.randint(0, 4 * N, (steps, N), generator=g)
    orders[0] = torch.arange(N) * 2 + (torch.arange(N) % 3 == 0).long()
    orders[0, 1], orders[0, 2] = 2, 5                 # P == Q, P == -Q
    orders[:, 7] = 14 + torch.arange(steps) % 2       # +Q, -Q, +Q, ...
    cnt = torch.randint(0, steps + 1, (N,), generator=g)
    cnt[[1, 2, 7]] = steps
    args = (table, orders.reshape(-1), torch.arange(N), torch.full((N,), N),
            cnt)
    cargs = [_cu(x, dev) for x in args]
    for mode in K.FIELD_MODES:
        with K.field_mode(mode):
            k = K.curve_bucket_drain(group, *cargs, 0, steps, acc=_cu(acc, dev))
            assert torch.equal(lb.widen(k.cpu()), K.curve_bucket_drain_plain(
                group, *args, 0, steps, acc=acc)), mode
            k = K.curve_bucket_drain(group, *cargs, 1)
            assert torch.equal(lb.widen(k.cpu()), K.curve_bucket_drain_plain(
                group, *args, 1)), mode
    b = torch.roll(acc, 1, -1)
    b[..., 5] = acc[..., 5]
    b[..., 6] = ops.neg(acc[..., 6:7])[..., 0]
    ok = torch.arange(N) % 5 != 2
    k = K.curve_add_where(group, _cu(acc, dev), _cu(b, dev), ok.to(dev))
    assert torch.equal(lb.widen(k.cpu()), K.curve_add_where_plain(group, acc, b, ok))
    h = acc[..., :20].contiguous()
    k = K.curve_window_combine(group, _cu(h, dev), 13)
    assert torch.equal(lb.widen(k.cpu()), K.curve_window_combine_plain(group, h, 13))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_reduce_and_combine_match_plain_on_card(dev, group):
    """curve_bucket_reduce over 3 windows of 64 buckets (two wide levels,
    then the tail; a split group of 8 sub-lanes; a bucket at infinity,
    equal buckets, P with -P) and curve_window_combine, in both builds."""
    ops = curve_ops(group)
    planes = _points(group, 64)
    base = ops.affine_to_xyzz(planes[0], planes[1],
                              torch.zeros(64, dtype=torch.bool))
    acc = torch.cat([base, ops.dbl(base),
                     ops.add_unified(base, torch.roll(base, 1, -1))], -1)
    acc = acc.reshape(acc.shape[:-1] + (3, 64)).clone()
    acc[..., 0, 0] = ops.inf_xyzz((1,))[..., 0]
    acc[..., 0, 3] = acc[..., 0, 2]
    acc[..., 1, 5] = ops.neg(acc[..., 1, 4:5])[..., 0]
    splits = [1, 1, 8]
    want = K.curve_bucket_reduce_plain(group, acc, splits)
    for mode in K.FIELD_MODES:
        with K.field_mode(mode):
            K.reset_launch_counts()
            k = K.curve_bucket_reduce(group, _cu(acc, dev), splits)
            assert torch.equal(lb.widen(k.cpu()), want), mode
            assert K.launch_counts(mode)[f"{group}_bucket_reduce"] == \
                K.bucket_reduce_launches(64) == 3
            k = K.curve_window_combine(group, _cu(want, dev), 13)
            assert torch.equal(lb.widen(k.cpu()),
                               K.curve_window_combine_plain(group, want, 13)), mode


def test_fq_chain_matches_plain_on_card(dev):
    g = torch.Generator().manual_seed(66)
    a = torch.randint(0, 1 << 32, (8, 64), generator=g, dtype=torch.int64)
    a[7] %= 0x30644E72
    b = torch.roll(a, 1, -1)
    for mode in K.FIELD_MODES:
        with K.field_mode(mode):
            k = K.fq_mul_chain(_cu(a, dev), _cu(b, dev), 7)
            assert torch.equal(lb.widen(k.cpu()), K.fq_mul_chain_plain(a, b, 7)), mode


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


def test_mma_product_matches_plain_on_card(dev):
    """The mma build's product (raw mma.sync over ldmatrix-loaded lane
    rows) through fr_mont_mul and the Fq probe at 3 warps + 5 lanes (the
    last warp clamped), with the edges 0, 1, p - 1, 2p - 1 (Fq's lazy
    values) and 2^256 - 1 against p - 1: equal to the CIOS build, the
    plain CIOS product and mont_mul_mma_plain."""
    from ultragroth_tpu_torch.constants import FQ_MODULUS as Q
    from ultragroth_tpu_torch.ops.field import fr
    from ultragroth_tpu_torch.ops.mxufield import mont_mul_mma_plain
    rng = random.Random(67)
    n = 3 * 32 + 5
    top = (1 << 256) - 1
    for F, kern, p in ((fr(), K.fr_mont_mul, R), (fq(), K.fq_mont_mul, Q)):
        a = [rng.randrange(p) for _ in range(n)]
        b = [rng.randrange(p) for _ in range(n)]
        a[:6] = [0, 1, p - 1, 2 * p - 1, top, p - 1]
        b[:6] = [p - 1, 1, p - 1, 2 * p - 1, p - 1, 0]
        a[-1], b[-1] = top, p - 1
        ta, tb = lb.ints_to_planes(a), lb.ints_to_planes(b)
        want = F.mont_mul(ta, tb)
        assert torch.equal(want, mont_mul_mma_plain(F, ta, tb))
        for mode in K.FIELD_MODES:
            with K.field_mode(mode):
                k = kern(_cu(ta, dev), _cu(tb, dev))
            assert torch.equal(lb.widen(k.cpu()), want), (F.name, mode)


@pytest.mark.parametrize("split", [1, 4])
def test_msm_fixed_merged_row_on_card_matches_cpu(dev, split, monkeypatch):
    """The fixed-base MSM's merged row on the card (one drain of `split`
    sub-lanes a bucket, one reduction, no add_where launch) equal to the
    CPU's, G1 and G2, c = 4 over 40 points."""
    from ultragroth_tpu_torch.ops import msm as M
    monkeypatch.setattr(M, "FIXED_SPLIT", split)
    rng = random.Random(68)
    sc = lb.ints_to_planes([rng.randrange(R) for _ in range(40)])
    for group in ("g1", "g2"):
        table = table_from_planes(_points(group, 40))
        inf = torch.zeros(40, dtype=torch.bool)
        ftab, finf, c = M.msm_fixed_table(group, table, inf, 4)
        want = M.msm_fixed(group, ftab, finf, sc, c)
        K.reset_launch_counts()
        got = M.msm_fixed(group, _cu(ftab, dev), finf.to(dev), _cu(sc, dev),
                          c)
        assert torch.equal(lb.widen(got.cpu()), want), group
        counts = K.launch_counts()
        assert counts[f"{group}_bucket_drain"] == 1
        assert counts[f"{group}_add_where"] == 0


def _edge_scalars(n, seed):
    """Canonical scalars [8, n] (int64 limbs) with the edge lanes: 0, 1,
    r - 1, a lone top byte, zero bytes in eight windows; lanes 128-255
    (a block) all zero."""
    rng = random.Random(seed)
    s = [rng.randrange(R) for _ in range(n)]
    s[:5] = [0, 1, R - 1, 0x30 << 248, 1 << 64]
    for k in range(5, 13):
        s[k] &= ~sum(0xFF << (8 * w) for w in range(k % 4, 32, 4))
    s[128:256] = [0] * len(s[128:256])
    return lb.ints_to_planes(s)


@pytest.mark.parametrize("mode", ["cios", "mma"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_mul_matches_plain_on_card(dev, mode, group):
    """The ladder over 300 lanes (three blocks: the edges, all at infinity,
    ragged) of the device set-up's window table, one launch."""
    table, tinf = _fb_table(group, dev)
    sc = _edge_scalars(300, 63)
    want = K.curve_fixed_base_mul_plain(group, lb.widen(table.cpu()),
                                        tinf.cpu(), sc)
    with K.field_mode(mode):
        K.reset_launch_counts()
        got = K.curve_fixed_base_mul(group, table, tinf, _cu(sc, dev))
        assert K.launch_counts(mode)[f"{group}_fixed_base_mul"] == 1
    for g, w in zip(got, want):
        assert torch.equal(lb.widen(g.cpu()) if g.dtype != torch.bool
                           else g.cpu(), w)
    assert int(want[2].sum()) == 129


@pytest.mark.parametrize("mode", ["cios", "mma"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_table_matches_plain_on_card(dev, mode, group):
    """The window table of 200 points (a ragged second block; points at
    infinity among them) at c = 17, 14 windows, one launch."""
    n, c = 200, 17
    planes = _points(group, n)
    inf = torch.zeros(n, dtype=torch.bool)
    inf[[0, 5, 130]] = True
    base = table_from_planes(planes)
    base[inf] = 0
    nw = 15
    want = torch.zeros((nw * n,) + tuple(base.shape[1:]), dtype=torch.int64)
    want[:n] = base
    K.curve_window_table_plain(group, base, inf, c, want)
    out = torch.zeros_like(want)
    out[:n] = base
    out = _cu(out, dev)
    with K.field_mode(mode):
        K.reset_launch_counts()
        got = K.curve_window_table(group, out[:n], inf.to(dev), c, out)
        assert K.launch_counts(mode)[f"{group}_window_table"] == 1
    assert torch.equal(lb.widen(got.cpu()), want)
    assert not bool(want[n:].reshape(nw - 1, n, -1)[:, inf].any())


@pytest.mark.parametrize("mode", ["cios", "mma"])
@pytest.mark.parametrize("log_m,cols,cb,fold", [
    (10, 4, 0, False), (10, 3, 1, True), (4, 37, 0, False), (4, 64, 4, True),
    (6, 40, 4, True), (1, 1, 0, False)])
def test_cg_ntt_matches_plain_on_card(dev, mode, log_m, cols, cb, fold):
    """Natural passes and the split's first pass (the folded twiddle and
    the transposed store), columns that do and do not fill a block, both
    builds."""
    g = torch.Generator().manual_seed(64 + log_m)
    m = 1 << log_m

    def field(*shape):
        t = torch.randint(0, 1 << 32, (8, int(np.prod(shape))), generator=g,
                          dtype=torch.int64)
        t[7] %= lb.int_to_limbs(R)[7]
        return t.reshape(8, *shape)

    x = field(m, cols)
    stw = field(cols // cb, m) if fold else None
    for inverse in (False, True):
        tw = Domain(log_m, "cpu").ntt_twiddles(log_m, inverse)
        with K.field_mode(mode):
            k = K.fr_cg_ntt(_cu(x, dev), _cu(tw, dev),
                            None if stw is None else _cu(stw, dev), cb)
        assert torch.equal(lb.widen(k.cpu()), K.fr_cg_ntt_plain(x, tw, stw, cb))


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
    # the card's default NTT mode is fast: no per-stage butterflies; the
    # fixed-base ladder belongs to the device set-up, the window table to
    # the fixed-base tables' build, add_where to their window folds (the
    # reduction has its own kernel)
    idle = {"fr_butterfly", "g1_fixed_base_mul", "g2_fixed_base_mul",
            "g1_window_table", "g2_window_table", "g1_add_where",
            "g2_add_where"}
    assert {k for k, v in K.launch_counts().items() if v == 0} == idle
    on_cpu = TorchGroth16Prover(zk, device="cpu").prove(w, r=11, s=22)
    assert on_card.to_json() == on_cpu.to_json()
    base = TorchGroth16Prover(zk, ntt_mode="base").prove(w, r=11, s=22)
    assert base.to_json() == on_cpu.to_json()


def test_small_ultragroth_prove_on_card_matches_cpu(dev):
    circ = LookupCircuit(np.random.default_rng(17).integers(0, 16, size=64),
                         16)
    setup = ultragroth_setup(circ.r1cs, circ.round_indexes,
                             circ.final_indexes, circ.rand_indx, seed=9)
    zk = parse_ultragroth_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    pins = dict(r0=33, r=11, s=22)
    K.reset_launch_counts()
    proof, w_final = TorchUltraGrothProver(zk).prove(wt.values, wt, **pins)
    assert K.launch_counts()["fr_cg_ntt"] > 0
    cpu_proof, cpu_w = TorchUltraGrothProver(zk, device="cpu").prove(
        wt.values, wt, **pins)
    assert proof.to_json() == cpu_proof.to_json() and w_final == cpu_w
    vk = ug.UltraGrothVerificationKey.from_json_dict(setup.vk_json)
    assert ug.verify(proof, ug.public_signals(w_final, zk.n_public,
                                              zk.rand_indx), vk)


def test_small_prove_in_mma_mode_matches_cpu(dev, monkeypatch):
    """ULTRAGROTH_MXU_FIELD=1: every kernel of the prove is of the mma
    build (the tensor-core reduction) and the proof equals the CPU's; a
    fixed-base table (ULTRAGROTH_FIXED_MSM_MB) changes nothing either."""
    r1cs, w = square_chain_circuit(60, seed=3)
    setup = groth16_setup(r1cs, seed=9)
    zk = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    monkeypatch.setenv("ULTRAGROTH_MXU_FIELD", "1")
    monkeypatch.setenv("ULTRAGROTH_FIXED_MSM_MB", "1")
    prover = TorchGroth16Prover(zk)
    monkeypatch.delenv("ULTRAGROTH_MXU_FIELD")
    assert prover.field_mode == "mma" and prover.fixed
    K.reset_launch_counts()
    on_card = prover.prove(w, r=11, s=22)
    assert sum(K.launch_counts("cios").values()) == 0
    assert K.launch_counts("mma")["g2_bucket_drain"] == 1
    on_cpu = TorchGroth16Prover(zk, device="cpu").prove(w, r=11, s=22)
    assert on_card.to_json() == on_cpu.to_json()


def test_server_cancel_on_card(dev, tmp_path):
    """The proof server on the card: a POSTed witness gives a verifying
    proof; /cancel during the next prove gives `aborted`."""
    import json
    import threading
    import time
    import urllib.request
    from ultragroth_tpu_torch import api, constants as C
    from ultragroth_tpu_torch.io.binfile import pack_binfile
    from ultragroth_tpu_torch.server import serve
    r1cs, w = square_chain_circuit(2000, seed=3)
    setup = groth16_setup(r1cs, seed=9)
    (tmp_path / "sq.zkey").write_bytes(setup.zkey_bytes)
    sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
            + r1cs.n_vars.to_bytes(4, "little"))
    wtns = pack_binfile(C.WTNS_MAGIC, 2, [(1, sec1), (2, w.tobytes())])
    fp, httpd = serve([str(tmp_path / "sq.zkey")], port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, data=b"", octet=False):
        hdr = {"Content-Type": "application/octet-stream"} if octet else {}
        urllib.request.urlopen(urllib.request.Request(f"{base}{path}",
                                                      data=data, headers=hdr))

    def wait(done):
        for _ in range(6000):
            st = json.load(urllib.request.urlopen(f"{base}/status"))
            if done(st["status"]):
                return st
            time.sleep(0.01)
        raise AssertionError(st)

    try:
        post("/input/sq", wtns, octet=True)
        st = wait(lambda s: s not in ("busy", "ready"))
        assert st["status"] == "success", st
        assert api.groth16_verify(st["proof"], st["pubData"],
                                  json.dumps(setup.vk_json)) \
            == api.VERIFIER_VALID_PROOF
        post("/input/sq", wtns, octet=True)
        post("/cancel")
        st = wait(lambda s: s != "busy")
        assert st["status"] == "aborted" and fp.proof is None, st
    finally:
        httpd.shutdown()


def test_mesh_prove_on_card_matches_cpu(dev):
    """The small prove over Mesh([cuda:0, cuda:0]) (two shards on one
    card): the CPU proof for the same r, s; each MSM's partials folded by
    one `curve_add_where` launch."""
    from ultragroth_tpu_torch.parallel import Mesh
    r1cs, w = square_chain_circuit(60, seed=3)
    setup = groth16_setup(r1cs, seed=9)
    zk = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    prover = TorchGroth16Prover(zk, mesh=Mesh([dev, dev]))
    K.reset_launch_counts()
    proof = prover.prove(w, r=11, s=22)
    got = K.launch_counts()
    assert (got["g1_add_where"], got["g2_add_where"]) == (4, 1)
    assert (got["g1_bucket_drain"], got["g2_bucket_drain"]) == (8, 2)
    on_cpu = TorchGroth16Prover(zk, device="cpu").prove(w, r=11, s=22)
    assert proof.to_json() == on_cpu.to_json()


@pytest.mark.parametrize("mode", ["fast", "base"])
def test_sharded_ntt_on_card_matches_cpu(dev, mode):
    from ultragroth_tpu_torch.ops.field import fr
    from ultragroth_tpu_torch.ops.ntt import ntt
    from ultragroth_tpu_torch.parallel import Mesh
    from ultragroth_tpu_torch.parallel.ntt import MeshDomain, ntt_sharded
    log_n = 12
    rng = random.Random(71)
    a = fr().to_mont(lb.ints_to_planes([rng.randrange(R)
                                        for _ in range(1 << log_n)]))
    want = ntt(a, Domain(log_n, "cpu"))
    dom = MeshDomain(log_n, Mesh([dev, dev]))
    got = ntt_sharded(_cu(a, dev), dom, mode=mode)
    assert torch.equal(lb.widen(got).cpu(), want)
    back = ntt_sharded(got, dom, inverse=True, mode=mode)
    assert torch.equal(lb.widen(back).cpu(), a)
