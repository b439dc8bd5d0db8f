"""PyTorch port: a true two-process run of the multi-device layer, the twin
of tests/test_distributed.py.

Two processes form a `torch.distributed` gloo group through the bootstrap
every entry point uses (`runtime.configure` ->
`parallel.mesh.distributed_init` from ULTRAGROTH_COORDINATOR /
NUM_PROCESSES / PROCESS_ID), build a ('host', 'chip') mesh whose 'host'
axis crosses the process boundary (`make_host_chip_mesh`: 2 processes x 2
CPU entries), and run the sharded MSM and the sharded quotient over it:
the partial points meet by `all_gather`, the NTT's transpose by
`all_to_all_single`.  Each process checks its results against the oracle
and the single-device quotient and prints a digest; the two digests must
agree.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 600

_CHILD = r"""
import json

from ultragroth_tpu_torch.runtime import configure
configure()   # -> distributed_init() from the ULTRAGROTH_* env

import torch
import torch.distributed as dist
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.field import fq, fr
from ultragroth_tpu_torch.ops.ntt import Domain, quotient_scalars
from ultragroth_tpu_torch.oracle import curve as oc
from ultragroth_tpu_torch.parallel.mesh import make_host_chip_mesh
from ultragroth_tpu_torch.parallel.msm import msm_g1_sharded
from ultragroth_tpu_torch.parallel.ntt import (MeshDomain,
                                               quotient_scalars_sharded)
from ultragroth_tpu_torch.protocol.prover import _xyzz_to_affine_host
from ultragroth_tpu_torch.ops.curve import table_from_planes

assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = make_host_chip_mesh(2, device="cpu")
assert mesh.shape == {"host": 2, "chip": 2}, mesh.shape
axis = ("host", "chip")

N = 64
pts = [oc.g1_mul(oc.G1, k + 2) for k in range(N)]
Fq = fq()
table = table_from_planes(torch.stack([
    Fq.to_mont(lb.ints_to_planes([p[0] for p in pts])),
    Fq.to_mont(lb.ints_to_planes([p[1] for p in pts]))]))
inf = torch.zeros(N, dtype=torch.bool)
sc_ints = [(11 * i + 5) for i in range(N)]
pt = msm_g1_sharded(table, inf, lb.ints_to_planes(sc_ints), mesh, axis,
                    c=8)
got = _xyzz_to_affine_host(lb.planes_to_ints(pt.T), False)
assert got == oc.g1_msm(pts, sc_ints), "msm vs oracle"

# the quotient over a 2^6 domain: six NTT passes whose transposes cross
# the process boundary
F = fr()
g = torch.Generator().manual_seed(7)
a = F.to_mont(torch.randint(0, 1 << 16, (8, N), generator=g))
b = F.to_mont(torch.randint(0, 1 << 16, (8, N), generator=g))
h = quotient_scalars_sharded(a, b, MeshDomain(6, mesh, axis))
assert torch.equal(h, quotient_scalars(a, b, Domain(6, "cpu"))), \
    "sharded quotient vs the single-device one"
print("DIGEST " + json.dumps({"msm": list(got),
                              "h": lb.planes_to_ints(h)[:8]}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_msm_and_quotient(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   ULTRAGROTH_COORDINATOR=f"127.0.0.1:{port}",
                   ULTRAGROTH_NUM_PROCESSES="2",
                   ULTRAGROTH_PROCESS_ID=str(pid),
                   ULTRAGROTH_PLATFORM="cpu",
                   OMP_NUM_THREADS="1",     # two processes, small tensors
                   PYTHONPATH=str(REPO))
        out = open(tmp_path / f"out{pid}", "w+")
        err = open(tmp_path / f"err{pid}", "w+")
        procs.append((subprocess.Popen([sys.executable, "-c", _CHILD],
                                       cwd=REPO, env=env, stdout=out,
                                       stderr=err), out, err))
    digests = []
    try:
        for p, out, err in procs:
            p.wait(timeout=TIMEOUT_S)
            out.seek(0)
            err.seek(0)
            assert p.returncode == 0, err.read()[-3000:]
            digests.append(json.loads(
                out.read().strip().splitlines()[-1].removeprefix("DIGEST ")))
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    assert digests[0] == digests[1], digests
