"""PyTorch port: the whole Groth16 prove on the CPU (plain versions of
every kernel), byte-identical to OracleGroth16Prover for pinned r, s, and
accepted by the verifier; the JAX prover's state carried across with
`convert`.  The comparison with JaxGroth16Prover and the JAX G2 MSM is a
`slow` test: their cold CPU compile takes up to ~20 minutes.
"""
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu.protocol import prover as jprover
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.fieldenc import array_to_ints
from ultragroth_tpu_torch.io.zkey import parse_groth16_zkey
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops import msm as M
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.protocol import groth16 as g16
from ultragroth_tpu_torch.protocol.prover import TorchGroth16Prover
from ultragroth_tpu_torch.testkit.circuits import square_chain_circuit
from ultragroth_tpu_torch.testkit.setup import groth16_setup

from tests.test_torch_field import affine_points, point_table

R_BLIND = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
S_BLIND = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09


@pytest.fixture(scope="module")
def chain():
    r1cs, w = square_chain_circuit(6, seed=3)
    setup = groth16_setup(r1cs, seed=9)
    zk = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    return zk, w, setup.vk_json


def test_prove_matches_oracle_and_verifies(chain):
    zk, w, vk_json = chain
    prover = TorchGroth16Prover(zk, device="cpu")
    proof = prover.prove(w, r=R_BLIND, s=S_BLIND)
    expected = g16.OracleGroth16Prover(zk).prove(w, r=R_BLIND, s=S_BLIND)
    assert proof.to_json() == expected.to_json()
    vk = g16.VerificationKey.from_json_dict(vk_json)
    publics = array_to_ints(w[1:zk.n_public + 1])
    assert g16.verify(proof, publics, vk)
    assert not g16.verify(proof, [publics[0] + 1], vk)
    assert list(prover.last_phase_ms) == [
        "upload", "msm_a", "msm_b1", "msm_b2", "msm_c", "scatter",
        "quotient", "msm_h", "finalize"]
    with pytest.raises(ValueError):
        prover.prove(w[:-1])


def test_prover_state_from_jax(chain):
    """The JAX prover's numpy state, carried across, is the port prover's."""
    zk = chain[0]
    state = {k: getattr(jprover, f"{g}_section_to_planes")(getattr(zk, k))
             for k, g in (("points_a", "g1"), ("points_b1", "g1"),
                          ("points_b2", "g2"), ("points_c", "g1"),
                          ("points_h", "g1"))}
    state["coef_val_mont"] = jprover.lb.words_to_planes(zk.coef_val)
    for k in ("coef_m", "coef_c", "coef_s"):
        state[k] = np.asarray(getattr(zk, k), np.int32)
    got = convert.prover_state_from_jax(state)
    prover = TorchGroth16Prover(zk, device="cpu")
    for k in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        assert torch.equal(got[k][0], getattr(prover, k)[0]), k
        assert torch.equal(got[k][1], getattr(prover, k)[1]), k
    for k in ("coef_val_mont", "coef_m", "coef_c", "coef_s"):
        assert torch.equal(got[k], getattr(prover, k)), k


@pytest.mark.slow
def test_prove_and_g2_msm_match_jax(chain):
    import jax
    from ultragroth_tpu.ops import limbs as jlb
    from ultragroth_tpu.ops import msm as dmsm
    from tests.test_curve_ops import g2_affine_from_device, g2_batch_to_planes
    zk, w, _ = chain
    proof = TorchGroth16Prover(zk, device="cpu").prove(w, r=R_BLIND, s=S_BLIND)
    jproof = jprover.JaxGroth16Prover(zk).prove(w, r=R_BLIND, s=S_BLIND)
    assert proof.to_json() == jproof.to_json()

    rng = random.Random(51)
    pts = [oc.g2_mul(oc.G2, rng.randrange(1, R)) for _ in range(17)]
    scalars = [rng.randrange(R) for _ in range(17)]
    x, y, inf = g2_batch_to_planes(pts)
    jout = dmsm.msm_g2(x, y, inf, jlb.ints_to_planes(scalars), c=8)
    exp = g2_affine_from_device(*jax.jit(dmsm.g2_ops().to_affine)(jout))[0]
    table, tinf = point_table("g2", pts)
    out = M.msm_g2(table, tinf, lb.ints_to_planes(scalars), c=8)
    assert affine_points("g2", out[..., None])[0] == exp
