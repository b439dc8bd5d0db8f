"""PyTorch port: the mesh provers (`mesh=` / `axis=` of the provers,
`devices=` of the api), the twin of the prover tests of
tests/test_parallel.py: with pinned randomness the sharded proves give the
single-device port's proof bytes, and the proofs verify.

Two shards: on the CPU every shard runs the plain versions of the kernels,
and a shard's MSM costs the same whatever its size (its bucket reduction
and window combine), so more shards only add minutes.  The UltraGroth
mesh prove (six MSMs on each side, ~45 s) and the comparison with the JAX
package's mesh prover (its cold XLA:CPU compiles) are `slow`.
"""
import json
import random

import numpy as np
import pytest
import torch

from ultragroth_tpu_torch import api
from ultragroth_tpu_torch import constants as C
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.io.binfile import pack_binfile
from ultragroth_tpu_torch.io.wtns import parse_wtns
from ultragroth_tpu_torch.io.zkey import (parse_groth16_zkey,
                                          parse_ultragroth_zkey)
from ultragroth_tpu_torch.parallel import Mesh
from ultragroth_tpu_torch.parallel import mesh as pmesh
from ultragroth_tpu_torch.protocol import ultragroth as ug
from ultragroth_tpu_torch.protocol.prover import (TorchGroth16Prover,
                                                  TorchUltraGrothProver)
from ultragroth_tpu_torch.testkit.circuits import (LookupCircuit,
                                                  square_chain_circuit)
from ultragroth_tpu_torch.testkit.setup import groth16_setup, ultragroth_setup

R_BLIND = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678
S_BLIND = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09
R0 = 0xAAAA567890ABCDEF1234567890ABCDEF1234567890ABCDEF12345678


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain kernel versions run many small tensor ops: one intra-op
    thread runs them faster here and leaves the other test workers'
    cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groth16_key():
    # domain 2^6: the JAX package's 8-device mesh cuts it too
    r1cs, wtns = square_chain_circuit(60, seed=31)
    setup = groth16_setup(r1cs, seed=32)
    assert parse_groth16_zkey(np.frombuffer(
        setup.zkey_bytes, np.uint8)).domain_size == 64
    sec1 = ((32).to_bytes(4, "little") + R.to_bytes(32, "little")
            + r1cs.n_vars.to_bytes(4, "little"))
    wtns_bytes = pack_binfile(C.WTNS_MAGIC, 2,
                              [(1, sec1), (2, wtns.tobytes())])
    return setup, wtns, wtns_bytes


def test_mesh_prover_through_api_devices(groth16_key, monkeypatch):
    """api.Groth16Prover(devices=2) on the CPU: the same proof JSON as the
    single-device prover for pinned r, s, and it verifies."""
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    setup, _, wt = groth16_key
    sharded = api.Groth16Prover(setup.zkey_bytes, device="cpu", devices=2)
    assert sharded._prover.mesh.shape == {"data": 2}
    proof, public = sharded.prove(wt, r=R_BLIND, s=S_BLIND)
    single = api.Groth16Prover(setup.zkey_bytes, device="cpu")
    assert (proof, public) == single.prove(wt, r=R_BLIND, s=S_BLIND)
    assert api.groth16_verify(proof, public, json.dumps(setup.vk_json)) \
        == api.VERIFIER_VALID_PROOF


@pytest.mark.slow
def test_mesh_prover_ultragroth_two_axis_bitexact():
    """The UltraGroth prover over a ('host', 'chip') mesh of two virtual
    hosts, sharded over both axes: proof and final witness equal the
    single-device prover's, and the 5-pairing verifier accepts."""
    rng = random.Random(11)
    circ = LookupCircuit(chunk_values=[rng.randrange(4) for _ in range(6)],
                         table_size=4)
    setup = ultragroth_setup(circ.r1cs, circ.round_indexes,
                             circ.final_indexes, circ.rand_indx, seed=3)
    zk = parse_ultragroth_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    wt = parse_wtns(np.frombuffer(circ.uwtns_bytes(), np.uint8))
    mesh = Mesh([["cpu"], ["cpu"]], ("host", "chip"))
    sharded = TorchUltraGrothProver(zk, device="cpu", mesh=mesh,
                                    axis=("host", "chip"))
    proof, w_f = sharded.prove(wt.values, wt, r0=R0, r=R_BLIND, s=S_BLIND)
    single, w_s = TorchUltraGrothProver(zk, device="cpu").prove(
        wt.values, wt, r0=R0, r=R_BLIND, s=S_BLIND)
    assert proof.to_json_dict() == single.to_json_dict()
    assert w_f == w_s
    vk = ug.UltraGrothVerificationKey.from_json_dict(setup.vk_json)
    assert ug.verify(proof, ug.public_signals(w_f, zk.n_public,
                                              zk.rand_indx), vk)


@pytest.mark.slow
def test_mesh_prover_matches_jax_mesh_prover(groth16_key):
    """The port's mesh prove against the JAX package's JaxGroth16Prover
    over its 8-device CPU mesh: the same proof for pinned r, s."""
    import jax
    from jax.sharding import Mesh as JMesh
    from ultragroth_tpu.io.zkey import parse_groth16_zkey as jparse
    from ultragroth_tpu.protocol.prover import JaxGroth16Prover
    setup, wtns, _ = groth16_key
    zk = parse_groth16_zkey(np.frombuffer(setup.zkey_bytes, np.uint8))
    port = TorchGroth16Prover(zk, device="cpu", mesh=Mesh(["cpu"] * 2))
    got = port.prove(wtns, r=R_BLIND, s=S_BLIND)
    jzk = jparse(np.frombuffer(setup.zkey_bytes, np.uint8))
    with JMesh(np.array(jax.devices()[:8]), ("data",)) as jmesh:
        want = JaxGroth16Prover(jzk, mesh=jmesh).prove(
            np.asarray(wtns), r=R_BLIND, s=S_BLIND)
    assert got.to_json_dict() == want.to_json_dict()
