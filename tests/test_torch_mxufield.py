"""PyTorch port: the MMA field (K8, the twin of `ultragroth_tpu/ops/
mxufield.py:mont_mul_mxu`).

`mont_mul_mma_plain` against the JAX package's `mont_mul_mxu` (called
eagerly, as tests/test_mxu_field.py does) and against the port's CIOS
product, Fr and Fq, random values with the edges and an `a < 2^256`
operand; then the g++ builds of `csrc/mma_field.cuh`: its lane-side steps
with plain-loop tile products, and, built with -DUG_MMA_FIELD=1, every
kernel's branch-free lane body over that product, held bit for bit
against the plain versions (the same checks as tests/test_torch_kernels.py
runs on the CIOS build).  Exact integer comparisons throughout.
"""
import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultragroth_tpu.ops.field import fq as jfq, fr as jfr
from ultragroth_tpu.ops.mxufield import mont_mul_mxu
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
from ultragroth_tpu_torch.ops import kernels as K
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops import mxufield
from ultragroth_tpu_torch.ops.field import fq, fr
from ultragroth_tpu_torch.ops.mxufield import mont_mul_mma_plain

from tests.test_torch_field import REPO, sample
from tests.test_torch_kernels import (
    CG_CASES, _Args, _cg_ntt_body,
    test_curve_lane_bodies_match_plain as _curve_bodies,
    test_fr_lane_bodies_match_plain as _fr_bodies,
    test_madd_valid_lane_body_matches_plain as _madd_valid_body)

FIELDS = {"fr": (fr, jfr, R), "fq": (fq, jfq, Q)}


def _operands(p, n, seed):
    """(a, b) value lists: canonical values with the edges 0, 1, p - 1, a
    lane of a < 2^256 against b < p, and lanes with both in [p, 2p) (the
    lazy Fq values)."""
    a = sample(p, n, seed)
    b = sample(p, n, seed + 1)[::-1]
    rng = np.random.default_rng(seed)
    a[-4:] = [(1 << 256) - 1, int.from_bytes(rng.bytes(32), "little"),
              p + 5, 2 * p - 1]
    b[-4:] = [p - 1, b[-3], 2 * p - 2, p + 7]
    return a, b


def _want(p, a, b):
    rinv = pow(1 << 256, -1, p)
    return [x * y * rinv % p for x, y in zip(a, b)]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_mul_mma_plain_matches_jax_mxu(name):
    """The JAX form (f32 byte limbs, Toeplitz dots) and the port's plain
    form of the same algorithm agree bit for bit, 48 lanes."""
    port_f, jax_f, p = FIELDS[name]
    a, b = _operands(p, 48, seed=3 if name == "fr" else 4)
    ta, tb = lb.ints_to_planes(a), lb.ints_to_planes(b)
    got = mont_mul_mma_plain(port_f(), ta, tb)
    want = mont_mul_mxu(jax_f(), jnp.asarray(convert.from_torch(ta)),
                        jnp.asarray(convert.from_torch(tb)))
    assert torch.equal(got, convert.to_torch(np.asarray(want)))
    assert lb.planes_to_ints(got) == _want(p, a, b)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_mul_mma_plain_matches_cios(name):
    """Against the port's CIOS product (canonical), int64 and int32
    storage, 256 lanes."""
    port_f, _, p = FIELDS[name]
    a, b = _operands(p, 256, seed=7)
    ta, tb = lb.ints_to_planes(a), lb.ints_to_planes(b)
    got = mont_mul_mma_plain(port_f(), ta, tb)
    assert torch.equal(got, port_f().mont_mul(ta, tb))
    got32 = mont_mul_mma_plain(port_f(), lb.narrow(ta, torch.int32),
                               lb.narrow(tb, torch.int32))
    assert got32.dtype == torch.int32 and torch.equal(lb.widen(got32), got)


def test_mxu_flag_and_field_mode(monkeypatch):
    for value, on in (("", False), ("0", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("ULTRAGROTH_MXU_FIELD", value)
        assert mxufield.enabled() is on
        assert mxufield.field_mode() == ("mma" if on else "cios")
    with pytest.raises(ValueError):
        with K.field_mode("f32"):
            pass
    with K.field_mode("mma"):
        assert K.current_field_mode() == "mma"
    assert K.current_field_mode() == "cios"


def test_cpu_ignores_the_field_mode(monkeypatch):
    """On the CPU the flag changes nothing (the JAX package's plain path
    never reaches mont_mul_mxu either): a prover records the mode it read
    when it was built, and a wrapper on CPU tensors runs its plain version
    in either mode and launches nothing."""
    from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
    from ultragroth_tpu_torch.protocol.prover import TorchGroth16Prover
    from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
    from ultragroth_tpu_torch.testkit.setup import groth16_setup
    r1cs, _ = square_chain_circuit(5, seed=11)
    zk = parse_groth16_zkey(np.frombuffer(groth16_setup(r1cs, seed=12)
                                          .zkey_bytes, np.uint8))
    monkeypatch.setenv("ULTRAGROTH_MXU_FIELD", "1")
    assert TorchGroth16Prover(zk, device="cpu").field_mode == "mma"
    monkeypatch.delenv("ULTRAGROTH_MXU_FIELD")
    assert TorchGroth16Prover(zk, device="cpu").field_mode == "cios"
    a = lb.ints_to_planes(sample(R, 16, seed=1))
    b = lb.ints_to_planes(sample(R, 16, seed=2))
    K.reset_launch_counts()
    with K.field_mode("mma"):
        got = K.fr_mont_mul(a, b)
    assert torch.equal(got, K.fr_mont_mul_plain(a, b))
    assert sum(K.launch_counts().values()) == 0


# -- mma_field.cuh built for the host --------------------------------------

def _harness(tmp_path_factory, defines):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available to build the host harness")
    out = tmp_path_factory.mktemp("harness") / "libug_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    *defines, "-o", str(out),
                    str(REPO / "ultragroth_tpu_torch" / "csrc" /
                        "host_harness.cpp")], check=True)
    return ctypes.CDLL(str(out), mode=os.RTLD_LOCAL)


@pytest.fixture(scope="module")
def mma_host_lib(tmp_path_factory):
    """The harness of the MMA build: every lane body branch-free, every
    product mma_field.cuh's (tile products as plain loops)."""
    lib = _harness(tmp_path_factory, ["-DUG_MMA_FIELD=1"])
    assert lib.ugh_mma_build() == 1
    return lib


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mma_lane_steps_match_plain(mma_host_lib, name):
    """mma_field.cuh's lane-side steps (schoolbook by carry chains, byte
    ripple, high half, conditional subtract on the 17th limb) with plain
    tile loops, against the plain version, and the Fq probe's lane body."""
    port_f, _, p = FIELDS[name]
    n = 64
    a, b = _operands(p, n, seed=21)
    A = _Args()
    ta, tb = lb.ints_to_planes(a), lb.ints_to_planes(b)
    out = np.zeros((8, n), np.uint32)
    mma_host_lib.ugh_mma_mont_mul(ctypes.c_int(0 if name == "fr" else 1),
                                  A.p(A.u32(ta)), A.p(A.u32(tb)), A.p(out),
                                  ctypes.c_int64(n))
    np.testing.assert_array_equal(out, A.u32(mont_mul_mma_plain(port_f(), ta,
                                                                tb)))
    if name == "fq":
        out = np.zeros((8, n), np.uint32)
        mma_host_lib.ugh_fq_mont_mul(A.p(A.u32(ta)), A.p(A.u32(tb)),
                                     A.p(out), ctypes.c_int64(n))
        np.testing.assert_array_equal(out, A.u32(K.fq_mont_mul_plain(ta,
                                                                     tb)))


def _edge_operands(p, n, seed):
    """`_operands` with the edges of the warp product's contract in the
    first lanes: 0, 1, p - 1 and 2p - 1 (the lazy Fq values) on either
    side, and 2^256 - 1 against p - 1 and 0."""
    a, b = _operands(p, n, seed)
    top = (1 << 256) - 1
    a[:8] = [0, 1, p - 1, 2 * p - 1, top, top, p - 1, 1]
    b[:8] = [p - 1, 2 * p - 1, p - 1, 2 * p - 1, p - 1, 0, 0, 1]
    return a, b


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mma_warp_product_matches_plain(mma_host_lib, name):
    """The device product's data movement, a warp's 32 lanes at a time
    (`mont_mul_mma_warp_ref`: the operand rows, ldmatrix.x4, the
    m16n8k32 fragments, the C pair stores and the row loads at the
    device's shared-memory offsets, with ldmatrix and mma done by their
    fragment maps), 77 lanes (a ragged last warp, clamped as the kernels
    clamp it), bit for bit against mont_mul_mma_plain, the CIOS product
    and the JAX `mont_mul_mxu`."""
    port_f, jax_f, p = FIELDS[name]
    n = 77
    a, b = _edge_operands(p, n, seed=31 if name == "fr" else 32)
    A = _Args()
    ta, tb = lb.ints_to_planes(a), lb.ints_to_planes(b)
    out = np.zeros((8, n), np.uint32)
    mma_host_lib.ugh_mma_mont_mul_warp(ctypes.c_int(0 if name == "fr" else 1),
                                       A.p(A.u32(ta)), A.p(A.u32(tb)),
                                       A.p(out), ctypes.c_int64(n))
    got = lb.widen(torch.from_numpy(out.view(np.int32)))
    assert torch.equal(got, mont_mul_mma_plain(port_f(), ta, tb))
    assert torch.equal(got, port_f().mont_mul(ta, tb))
    want = mont_mul_mxu(jax_f(), jnp.asarray(convert.from_torch(ta)),
                        jnp.asarray(convert.from_torch(tb)))
    assert torch.equal(got, lb.widen(convert.to_torch(np.asarray(want))))
    assert lb.planes_to_ints(got) == _want(p, a, b)


def test_mma_shared_memory_maps_are_conflict_free(mma_host_lib):
    """The swizzled offsets of the warp product (csrc/mma_field.cuh): in
    every phase of a shared-memory access (8 threads for 16 bytes, 16
    for 8 bytes, one 8-row matrix of an ldmatrix.x4) the threads' 4-byte
    banks are distinct; the operand row is chunks 8 and 9 of the lane's
    column-sum row, which the Np step's C stores (columns 0..31) leave
    alone."""
    op = np.zeros((32, 2), np.int32)
    cs = np.zeros((32, 40), np.int32)
    ldm = np.zeros((2, 32), np.int32)
    cst = np.zeros((2, 2, 32, 5), np.int32)
    A = _Args()
    mma_host_lib.ugh_mma_maps(A.p(op), A.p(cs), A.p(ldm), A.p(cst))

    def free(words, width):
        banks = [(w + k) % 32 for w in words for k in range(width)]
        return len(set(banks)) == len(banks)

    for g in range(4):                      # 16-byte accesses, 8 lanes
        lanes = range(8 * g, 8 * g + 8)
        assert all(free([op[l, h] // 4 for l in lanes], 4) for h in (0, 1))
        assert all(free([cs[l, 4 * q] for l in lanes], 4) for q in range(10))
        assert all(free([ldm[mt, l] // 4 for l in lanes], 4) for mt in (0, 1))
    for half in (range(16), range(16, 32)):   # 8-byte C pair stores
        for mt in (0, 1):
            for pp in (0, 1):
                assert all(free([cst[mt, pp, l, j] for l in half], 2)
                           for j in range(5))
    assert sorted(set(cs.reshape(-1))) == list(range(32 * 40))
    assert (op == 4 * cs[:, [32, 36]]).all()
    np_words = {int(cst[mt, pp, l, j]) + k for mt in (0, 1) for pp in (0, 1)
                for l in range(32) for j in range(4) for k in (0, 1)}
    assert not np_words & {int(w) // 4 + k for w in op.reshape(-1)
                           for k in range(4)}


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_mma_build_curve_lane_bodies_match_plain(mma_host_lib, group):
    _curve_bodies(mma_host_lib, group)
    _madd_valid_body(mma_host_lib, group)


def test_mma_build_fr_lane_bodies_match_plain(mma_host_lib):
    _fr_bodies(mma_host_lib)


@pytest.mark.parametrize("log_m,cols,cb,fold", CG_CASES)
def test_mma_build_cg_ntt_body_matches_plain(mma_host_lib, log_m, cols, cb,
                                            fold):
    _cg_ntt_body(mma_host_lib, log_m, cols, cb, fold)
