"""PyTorch port: the multi-device layer (`parallel/`) on CPU meshes, the
twin of tests/test_parallel.py: the sharded NTT and MSM against the oracle
and against the JAX package's `parallel.ntt`, the meshes' construction and
errors, `distributed_init` without its variables, and the `devices` /
`--devices` surface of `api`, `cli` and `server`.

A CPU mesh repeats the one `cpu` device (the counterpart of the JAX tests'
eight forced host devices, tests/conftest.py); every shard runs the plain
versions of the kernels, so the MSM's shard count stays small where the
proves would take minutes.
"""
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ultragroth_tpu.ops import limbs as jlb
from ultragroth_tpu.ops.field import fr as jfr
from ultragroth_tpu.parallel.ntt import ntt_sharded as jntt_sharded
from ultragroth_tpu_torch import api, cli, server
from ultragroth_tpu_torch.constants import FR_MODULUS as R
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops import ntt as N
from ultragroth_tpu_torch.ops.field import fr
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.parallel import Mesh, make_mesh
from ultragroth_tpu_torch.parallel import mesh as pmesh
from ultragroth_tpu_torch.parallel.msm import (msm_g1_sharded,
                                               msm_g2_sharded, padded_size)
from ultragroth_tpu_torch.parallel.ntt import (MeshDomain, ntt_sharded,
                                               quotient_scalars_sharded)
from ultragroth_tpu_torch.protocol import quotient as oq
from ultragroth_tpu_torch.protocol.transcript import root_of_unity

from tests.test_torch_field import affine_points, point_table

FR = fr()
CPU8 = Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain kernel versions run many small tensor ops: one intra-op
    thread runs them faster here and leaves the other test workers'
    cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(n)]


@pytest.mark.parametrize("mode", ["base", "fast"])
def test_sharded_ntt_vs_oracle(mode):
    log_n = 8
    vals = _vals(1 << log_n, 42)
    w = root_of_unity(log_n)
    dom = MeshDomain(log_n, CPU8)
    got = ntt_sharded(FR.to_mont(lb.ints_to_planes(vals)), dom, mode=mode)
    assert lb.planes_to_ints(FR.from_mont(got)) == oq.ntt(vals, w)
    back = ntt_sharded(FR.to_mont(lb.ints_to_planes(oq.ntt(vals, w))), dom,
                       inverse=True, mode=mode)
    assert lb.planes_to_ints(FR.from_mont(back)) == vals


def test_sharded_ntt_matches_jax_ntt_sharded():
    """The port's ntt_sharded against the JAX package's on its 8-device
    CPU mesh, forward and inverse, as integers."""
    log_n = 8
    vals = _vals(1 << log_n, 43)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("data",))
    ja = jfr().to_mont(jlb.ints_to_planes(vals))
    a = FR.to_mont(lb.ints_to_planes(vals))
    dom = MeshDomain(log_n, CPU8)
    for inverse in (False, True):
        with jmesh:
            want = np.asarray(jntt_sharded(ja, log_n, jmesh,
                                           inverse=inverse))
        got = ntt_sharded(a, dom, inverse=inverse)
        assert lb.planes_to_ints(got) == jlb.planes_to_ints(want)


def test_two_axis_mesh_ntt_and_quotient():
    """A ('host', 'chip') mesh of 2 virtual hosts x 4 chips in one process,
    sharded over both axes: the NTT equals the single-device one and the
    sharded quotient the single-device quotient; over 'chip' alone (host
    replicated) the same values."""
    log_n = 6
    a = FR.to_mont(lb.ints_to_planes(_vals(1 << log_n, 44)))
    b = FR.to_mont(lb.ints_to_planes(_vals(1 << log_n, 45)))
    mesh = Mesh([["cpu"] * 4, ["cpu"] * 4], ("host", "chip"))
    single = N.Domain(log_n, "cpu")
    for axis, count in ((("host", "chip"), 8), ("chip", 4)):
        dom = MeshDomain(log_n, mesh, axis)
        assert dom.sh.count == count
        assert torch.equal(ntt_sharded(a, dom), N.ntt(a, single))
    assert torch.equal(quotient_scalars_sharded(a, b, dom, "fast"),
                       N.quotient_scalars(a, b, single))


def test_sharded_msm_vs_oracle():
    """n = 96 over 8 shards at c = 8, the last scalar 0: padded to 128, so
    the last two shards hold only infinity points."""
    rng = random.Random(42)
    n = 96
    pts = [oc.g1_mul(oc.G1, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n - 1)] + [0]
    assert padded_size(n, 8) == 128
    table, inf = point_table("g1", pts)
    out = msm_g1_sharded(table, inf, lb.ints_to_planes(scalars), CPU8, c=8)
    assert affine_points("g1", out[..., None])[0] == oc.g1_msm(pts, scalars)


def test_sharded_msm_g2_vs_oracle():
    rng = random.Random(48)
    n = 20
    pts = [oc.g2_mul(oc.G2, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    table, inf = point_table("g2", pts)
    out = msm_g2_sharded(table, inf, lb.ints_to_planes(scalars),
                         Mesh(["cpu"] * 2), c=8)
    assert affine_points("g2", out[..., None])[0] == oc.g2_msm(pts, scalars)


def test_sharded_msm_rejects_non_canonical_scalars():
    pts = [oc.g1_mul(oc.G1, 2), oc.g1_mul(oc.G1, 3)]
    table, inf = point_table("g1", pts)
    with pytest.raises(ValueError):
        msm_g1_sharded(table, inf, lb.ints_to_planes([1, R]),
                       Mesh(["cpu"] * 2), c=8)


def test_make_mesh_errors_and_rounding(monkeypatch):
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 6)
    with pytest.raises(ValueError, match="device count must be a power of "
                                         "two, got 3"):
        make_mesh(3)
    with pytest.raises(ValueError, match="need 8 devices, have 6"):
        make_mesh(8)
    with pytest.raises(ValueError, match="need -1 devices, have 6"):
        make_mesh(-1)
    for n in (None, 0, "all"):
        assert make_mesh(n).shape == {"data": 4}
    assert make_mesh(2, axis="x").shape == {"x": 2}


def test_mesh_construction_and_shards(monkeypatch):
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    mesh = pmesh.make_host_chip_mesh(8)
    assert mesh.axis_names == ("host", "chip")
    assert mesh.shape == {"host": 1, "chip": 8} and mesh.group is None
    assert pmesh.axis_size(mesh, ("host", "chip")) == 8
    assert pmesh.axis_size(mesh, "chip") == 8
    assert pmesh.shards(mesh, pmesh.DATA_AXES).count == 8
    with pytest.raises(ValueError, match="not in mesh"):
        pmesh.shards(mesh, "data")
    with pytest.raises(ValueError):
        Mesh([["cpu"] * 2, ["cpu"]], ("host", "chip"))
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("host", "chip"))
    assert make_mesh(4, device="cpu").devices == (torch.device("cpu"),) * 4


def test_distributed_init_noop(monkeypatch):
    monkeypatch.delenv("ULTRAGROTH_COORDINATOR", raising=False)
    assert pmesh.distributed_init() is False
    assert not torch.distributed.is_initialized()


def test_api_devices_builds_a_mesh(monkeypatch):
    from ultragroth_tpu_torch.testkit.circuits import (LookupCircuit,
                                                      square_chain_circuit)
    from ultragroth_tpu_torch.testkit.setup import (groth16_setup,
                                                   ultragroth_setup)
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    r1cs, _ = square_chain_circuit(5, seed=11)
    zkey = groth16_setup(r1cs, seed=12).zkey_bytes
    circ = LookupCircuit(chunk_values=[1, 0, 1], table_size=2)
    uzkey = ultragroth_setup(circ.r1cs, circ.round_indexes,
                             circ.final_indexes, circ.rand_indx,
                             seed=21).zkey_bytes
    assert api.Groth16Prover(zkey, device="cpu")._prover.mesh is None
    p = api.Groth16Prover(zkey, device="cpu", devices=2)
    assert p._prover.mesh.shape == {"data": 2}
    assert p._prover.fixed == {}
    u = api.UltraGrothProver(uzkey, device="cpu", devices="all")
    assert u._prover.mesh.shape == {"data": 4}
    with pytest.raises(ValueError, match="power of two"):
        api.Groth16Prover(zkey, device="cpu", devices=3)


def test_cli_and_server_devices_flag(monkeypatch, tmp_path):
    """--devices reaches the api as JAX's cli / server pass it: absent or
    "1" -> one device, else the flag's value."""
    seen = []

    class Stub:
        def __init__(self, *a, **kw):
            seen.append(kw.get("devices"))
            raise api.ProverError("stub")

        from_file = classmethod(lambda cls, *a, **kw: cls(*a, **kw))

    monkeypatch.setattr(api, "Groth16Prover", Stub)
    monkeypatch.setattr(api, "UltraGrothProver", Stub)
    files = [str(tmp_path / f) for f in ("c.zkey", "w.wtns", "p", "q")]
    for flag, want in ((None, None), ("1", None), ("2", "2"),
                       ("all", "all")):
        seen.clear()
        extra = [] if flag is None else ["--devices", flag]
        assert cli.main(["prove", *files, *extra]) == 1
        assert seen == [want]
    served = []

    def fake_serve(*args, devices=None, **kw):
        served.append(devices)
        raise SystemExit(0)

    monkeypatch.setattr(server, "serve", fake_serve)
    for flag, want in ((["--devices", "1"], None), (["--devices", "4"], "4"),
                       ([], None)):
        with pytest.raises(SystemExit):
            server.main(["c.zkey", *flag])
        assert served[-1] == want
