"""PyTorch port: UltraGroth and the device set-up.

  * Keccak and the Fiat-Shamir challenge equal the JAX package's;
  * the repaired `LookupCircuit` gives the JAX package's frequencies,
    R1CS and .uwtns bytes;
  * the device set-up (`testkit/dsetup.py`, plain versions on the CPU) is
    byte-identical to the JAX package's HOST set-ups
    (`ultragroth_tpu.testkit.setup`, Python big-int code: no XLA compile)
    on the circuits of tests/test_dsetup.py; against the JAX package's
    device set-up it is a `slow` test (tests/test_dsetup.py compiles for
    minutes on the CPU);
  * `TorchUltraGrothProver(device="cpu")` equals the JAX package's
    oracle (`OracleUltraGrothProver`, Python big-int code: no XLA compile)
    and the port's copy of it for pinned r0, r, s on the fixture of
    tests/test_ultragroth.py; its proof
    verifies, and fails after a tampered public input or round
    commitment.  Against `JaxUltraGrothProver` it is a `slow` test: its
    G2 MSM compiles for many minutes on the CPU.
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu import keccak as jkeccak
from ultragroth_tpu.io import wtns as jwtns
from ultragroth_tpu.io import zkey as jzkey
from ultragroth_tpu.protocol import prover as jprover
from ultragroth_tpu.protocol import ultragroth as jug
from ultragroth_tpu.testkit import circuits as jcircuits
from ultragroth_tpu.testkit import setup as jsetup
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.wtns import parse_wtns
from ultragroth_tpu_torch.io.zkey import parse_ultragroth_zkey
from ultragroth_tpu_torch.keccak import keccak256
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol import ultragroth as ug
from ultragroth_tpu_torch.protocol.prover import TorchUltraGrothProver
from ultragroth_tpu_torch.testkit.circuits import (LookupCircuit,
                                                  square_chain_circuit)
from ultragroth_tpu_torch.testkit.dsetup import (groth16_setup_fast,
                                                 ultragroth_setup_fast)
from ultragroth_tpu_torch.testkit.setup import ultragroth_setup

R0 = 0xAAAA567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
RB = 0xBBBB567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
SB = 0xCCCC567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
FIXTURE = ([3, 1, 3, 0, 2, 3], 4)          # tests/test_ultragroth.py


def _same_setup(a, b):
    assert a.taus == b.taus
    assert a.zkey_bytes == b.zkey_bytes
    assert a.vk_json == b.vk_json


def test_keccak_and_challenge_match_jax():
    rng = np.random.default_rng(80)
    for n in (0, 1, 64, 135, 136, 137, 300):
        data = rng.bytes(n)
        assert keccak256(data) == jkeccak.keccak256(data)
    rnd = random.Random(81)
    for p in [None] + [oc.g1_mul(oc.G1, rnd.randrange(1, R)) for _ in range(3)]:
        assert ug.derive_challenge(p) == jug.derive_challenge(p)


@pytest.mark.parametrize("chunks,table", [FIXTURE, (None, 16)])
def test_lookup_circuit_matches_jax(chunks, table):
    if chunks is None:
        chunks = np.random.default_rng(17).integers(0, table, size=64).tolist()
    port = LookupCircuit(chunks, table)
    ref = jcircuits.LookupCircuit(chunks, table)
    assert port.frequencies == ref.frequencies
    assert port.r1cs.rows == ref.r1cs.rows
    assert port.r1cs.n_vars == ref.r1cs.n_vars
    assert (port.witness_words() == ref.witness_words()).all()
    assert port.uwtns_bytes() == ref.uwtns_bytes()


def test_groth16_setup_fast_matches_jax_host_setup():
    r1cs, _ = square_chain_circuit(12, seed=2)
    ref_r1cs, _ = jcircuits.square_chain_circuit(12, seed=2)
    _same_setup(groth16_setup_fast(r1cs, seed=9, device="cpu"),
                jsetup.groth16_setup(ref_r1cs, seed=9))


def test_ultragroth_setup_fast_matches_jax_host_setup():
    circ = LookupCircuit(*FIXTURE)
    ref = jcircuits.LookupCircuit(*FIXTURE)
    fast = ultragroth_setup_fast(circ.r1cs, circ.round_indexes,
                                 circ.final_indexes, circ.rand_indx, seed=7,
                                 device="cpu")
    _same_setup(fast, jsetup.ultragroth_setup(
        ref.r1cs, ref.round_indexes, ref.final_indexes, ref.rand_indx, seed=7))
    assert set(fast.seconds) == {"records", "scalars", "fixed_base", "encode"}


@pytest.mark.slow
def test_device_setups_match_jax_device_setups():
    from ultragroth_tpu.testkit import dsetup as jdsetup
    r1cs, _ = square_chain_circuit(12, seed=2)
    _same_setup(groth16_setup_fast(r1cs, seed=9, device="cpu"),
                jdsetup.groth16_setup_fast(r1cs, seed=9))
    circ = LookupCircuit(*FIXTURE)
    args = (circ.r1cs, circ.round_indexes, circ.final_indexes, circ.rand_indx)
    _same_setup(ultragroth_setup_fast(*args, seed=7, device="cpu"),
                jdsetup.ultragroth_setup_fast(*args, seed=7))


@pytest.fixture(scope="module")
def fixture():
    circ = LookupCircuit(*FIXTURE)
    setup = ultragroth_setup(circ.r1cs, circ.round_indexes,
                             circ.final_indexes, circ.rand_indx, seed=7)
    zk = parse_ultragroth_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    return circ, setup, zk, wt


def test_prove_matches_oracle_and_verifies(fixture):
    circ, setup, zk, wt = fixture
    prover = TorchUltraGrothProver(zk, device="cpu")
    assert prover.ntt_mode == "base"
    proof, w_final = prover.prove(wt.values, wt, r0=R0, r=RB, s=SB)
    jzk = jzkey.parse_ultragroth_zkey(np.frombuffer(setup.zkey_bytes,
                                                     np.uint8))
    jwt = jwtns.parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    expected, w_j = jug.OracleUltraGrothProver(jzk).prove(
        jwt.values, jwt, r0=R0, r=RB, s=SB)
    port_oracle, w_o = ug.OracleUltraGrothProver(zk).prove(
        wt.values, wt, r0=R0, r=RB, s=SB)
    assert proof.to_json() == expected.to_json() == port_oracle.to_json()
    assert w_final == w_j == w_o
    assert list(prover.last_phase_ms) == [
        "round0_commit", "lookup", "msm_a", "msm_b1", "msm_b2", "msm_c",
        "scatter", "quotient", "msm_h", "finalize"]

    vk = ug.UltraGrothVerificationKey.from_json_dict(setup.vk_json)
    publics = ug.public_signals(w_final, zk.n_public, zk.rand_indx)
    assert publics == [circ.pub_x]
    assert ug.verify(proof, publics, vk)
    assert ug.derive_challenge(proof.pi_r) == w_final[zk.rand_indx]
    assert not ug.verify(proof, [(circ.pub_x + 1) % R], vk)
    bad = ug.UltraGrothProof(proof.pi_a, proof.pi_b, proof.pi_f,
                             oc.g1_add(proof.pi_r, oc.G1))
    assert not ug.verify(bad, publics, vk)
    with pytest.raises(ValueError):
        prover.prove(wt.values[:-1], wt)


def test_ultragroth_prover_state_from_jax(fixture):
    """The JAX UltraGroth prover's numpy state, carried across, is the
    port prover's."""
    zk = fixture[2]
    g1 = ("points_a", "points_b1", "points_h", "round_points_c",
          "final_points_c")
    state = {k: jprover.g1_section_to_planes(getattr(zk, k)) for k in g1}
    state["points_b2"] = jprover.g2_section_to_planes(zk.points_b2)
    state["coef_val_mont"] = jprover.lb.words_to_planes(zk.coef_val)
    ints = ("coef_m", "coef_c", "coef_s", "round_indexes", "final_indexes")
    for k in ints:
        state[k] = np.asarray(getattr(zk, k), np.int32)
    got = convert.prover_state_from_jax(state)
    prover = TorchUltraGrothProver(zk, device="cpu")
    for k in g1 + ("points_b2",):
        assert torch.equal(got[k][0], getattr(prover, k)[0]), k
        assert torch.equal(got[k][1], getattr(prover, k)[1]), k
    for k in ("coef_val_mont",) + ints:
        assert torch.equal(got[k], getattr(prover, k)), k


@pytest.mark.slow
def test_prove_matches_jax_ultragroth_prover(fixture):
    circ, setup, zk, wt = fixture
    proof, w_final = TorchUltraGrothProver(zk, device="cpu").prove(
        wt.values, wt, r0=R0, r=RB, s=SB)
    jproof, jw = jprover.JaxUltraGrothProver(zk).prove(
        wt.values, wt, r0=R0, r=RB, s=SB)
    assert proof.to_json() == jproof.to_json()
    assert w_final == jw
