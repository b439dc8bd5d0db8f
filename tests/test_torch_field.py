"""PyTorch port: limb layout, JAX <-> port conversion, package isolation,
and the plain Fr / Fq / Fq2 ops held against the JAX package's FieldOps.

Shared helpers for the other tests/test_torch_*.py files live here too.
Every comparison is exact on integers after canonicalisation.
"""
import pathlib
import random
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultragroth_tpu.ops import limbs as jlb
from ultragroth_tpu.ops.field import fq as jfq, fr as jfr
from ultragroth_tpu.ops.fq2 import Fq2Ops as JFq2Ops
from ultragroth_tpu_torch import convert
from ultragroth_tpu_torch.constants import FQ_MODULUS as Q, FR_MODULUS as R
from ultragroth_tpu_torch.ops import limbs as lb
from ultragroth_tpu_torch.ops.curve import curve_ops, table_from_planes
from ultragroth_tpu_torch.ops.field import fq, fr
from ultragroth_tpu_torch.ops.fq2 import Fq2Ops
from ultragroth_tpu_torch.oracle import curve as oc

REPO = pathlib.Path(__file__).resolve().parent.parent


def sample(p, n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") % p
                   for _ in range(n - len(edge))]
    return vals[:n]


# -- helpers shared by the port's tests ------------------------------------

def g1_table(points):
    """Oracle affine G1 list (None = infinity) -> (table [2, 8, N], inf)."""
    F = fq()
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    tab = torch.stack([F.to_mont(lb.ints_to_planes(xs)),
                       F.to_mont(lb.ints_to_planes(ys))])
    return tab, torch.tensor([p is None for p in points])


def g2_table(points):
    """Oracle affine G2 list -> (table [2, 2, 8, N], inf)."""
    F = fq()
    comps = [F.to_mont(lb.ints_to_planes(
        [0 if p is None else p[c][k] for p in points]))
        for c in range(2) for k in range(2)]
    tab = torch.stack([torch.stack(comps[:2]), torch.stack(comps[2:])])
    return tab, torch.tensor([p is None for p in points])


def point_table(group, points):
    """Oracle affine list -> (the MSMs' point-major table [N, 2, *elem],
    inf)."""
    tab, inf = (g1_table if group == "g1" else g2_table)(points)
    return table_from_planes(tab), inf


def affine_points(group, pts):
    """Port xyzz batch [4, *elem, N] -> list of oracle affine points."""
    F = fq()
    x, y, inf = curve_ops(group).to_affine(pts)
    if group == "g1":
        xs = lb.planes_to_ints(F.from_mont(x))
        ys = lb.planes_to_ints(F.from_mont(y))
        return [None if inf[i] else (xs[i], ys[i]) for i in range(len(xs))]
    v = [lb.planes_to_ints(F.from_mont(t)) for t in (x[0], x[1], y[0], y[1])]
    return [None if inf[i] else ((v[0][i], v[1][i]), (v[2][i], v[3][i]))
            for i in range(len(v[0]))]


def random_points(group, n, seed):
    rng = random.Random(seed)
    if group == "g1":
        return [oc.g1_mul(oc.G1, rng.randrange(1, 1 << 64)) for _ in range(n)]
    return [oc.g2_mul(oc.G2, rng.randrange(1, 1 << 64)) for _ in range(n)]


def xyzz_to_jax(group, p):
    """Port xyzz [4, *elem, N] -> the JAX package's pytree of [16, N]."""
    if group == "g1":
        return tuple(jnp.asarray(convert.from_torch(p[i])) for i in range(4))
    return tuple((jnp.asarray(convert.from_torch(p[i, 0])),
                  jnp.asarray(convert.from_torch(p[i, 1]))) for i in range(4))


def xyzz_from_jax(group, t):
    if group == "g1":
        return torch.stack([convert.to_torch(np.asarray(c)) for c in t])
    return torch.stack([torch.stack([convert.to_torch(np.asarray(c[0])),
                                     convert.to_torch(np.asarray(c[1]))])
                        for c in t])


def elem_to_jax(group, e):
    """Port element [*elem, N] -> JAX leaf or (c0, c1) pair."""
    if group == "g1":
        return jnp.asarray(convert.from_torch(e))
    return (jnp.asarray(convert.from_torch(e[0])),
            jnp.asarray(convert.from_torch(e[1])))


# -- layout ----------------------------------------------------------------

@pytest.mark.parametrize("p", [R, Q], ids=["fr", "fq"])
def test_limbs_and_convert_roundtrip(p):
    vals = sample(p, 37, seed=1) + [(1 << 256) - 1]
    planes = lb.ints_to_planes(vals)
    assert planes.shape == (8, len(vals)) and planes.dtype == torch.int64
    assert lb.planes_to_ints(planes) == vals
    words = lb.planes_to_words(planes)
    assert torch.equal(lb.words_to_planes(words), planes)
    # int32 storage keeps the u32 bit pattern
    n32 = lb.narrow(planes, torch.int32)
    assert torch.equal(lb.widen(n32), planes)
    # the JAX package's [16, N] planes carry the same integers
    p16 = jlb.ints_to_planes(vals)
    np.testing.assert_array_equal(convert.planes16_to_planes8(p16),
                                  planes.numpy().astype(np.uint32))
    np.testing.assert_array_equal(convert.planes8_to_planes16(
        convert.planes16_to_planes8(p16)), p16)
    assert torch.equal(convert.to_torch(p16), planes)
    np.testing.assert_array_equal(convert.from_torch(planes), p16)
    # wire words agree with the JAX package's word layout
    np.testing.assert_array_equal(jlb.planes_to_words(p16), words)


def test_port_imports_without_jax():
    """The port (and chip_smoke.py's and the tools' imports) load with jax
    and ultragroth_tpu made unimportable; the C ABI shim, the remote client
    and the native runtime build without them."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ultragroth_tpu'] = None\n"
        "import ultragroth_tpu_torch\n"
        "from ultragroth_tpu_torch.protocol.prover import (\n"
        "    TorchGroth16Prover, TorchUltraGrothProver)\n"
        "from ultragroth_tpu_torch.protocol import ultragroth\n"
        "from ultragroth_tpu_torch.ops import kernels, msm, ntt, _build\n"
        "from ultragroth_tpu_torch.ops import mxufield\n"
        "from ultragroth_tpu_torch.ops.ntt import ntt_fast, ntt_mode\n"
        "from ultragroth_tpu_torch.ops.msm import (\n"
        "    msm_fixed, msm_fixed_stages, msm_fixed_table)\n"
        "from ultragroth_tpu_torch.ops.kernels import (\n"
        "    curve_bucket_drain, curve_bucket_drain_plain,\n"
        "    curve_fixed_base_mul, curve_window_table)\n"
        "from ultragroth_tpu_torch import convert, keccak, trace\n"
        "from ultragroth_tpu_torch import api, cli, log, runtime, server\n"
        "from ultragroth_tpu_torch import capi, native\n"
        "from ultragroth_tpu_torch.parallel import Mesh, make_mesh\n"
        "from ultragroth_tpu_torch.parallel import mesh, msm, ntt\n"
        "capi.build_libraries()\n"
        "assert native.available()\n"
        "from ultragroth_tpu_torch.testkit import setup, circuits, dsetup\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_drain_variants, torch_ntt_variants, torch_variants\n"
        "import torch_chain_variants, torch_mma_variants\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or\n"
        "               m.startswith('ultragroth_tpu.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ultragroth_tpu)(\.|\s|$)",
                     re.M)
    files = list((REPO / "ultragroth_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


# -- Fr / Fq against the JAX package --------------------------------------

@pytest.mark.parametrize("name,p", [("fr", R), ("fq", Q)], ids=["fr", "fq"])
def test_field_ops_match_jax(name, p):
    F, JF = (fr(), jfr()) if name == "fr" else (fq(), jfq())
    a = sample(p, 32, seed=2)
    b = list(reversed(sample(p, 32, seed=3)))
    A, B = lb.ints_to_planes(a), lb.ints_to_planes(b)
    JA, JB = jlb.ints_to_planes(a), jlb.ints_to_planes(b)
    pairs = [(F.add(A, B), JF.add(JA, JB)), (F.sub(A, B), JF.sub(JA, JB)),
             (F.neg(A), JF.neg(JA)), (F.mont_mul(A, B), JF.mont_mul(JA, JB)),
             (F.to_mont(A), JF.to_mont(JA)), (F.from_mont(A), JF.from_mont(JA))]
    for got, exp in pairs:
        assert lb.planes_to_ints(got) == jlb.planes_to_ints(np.asarray(exp))
    # inversion in the Montgomery domain, inv(0) = 0
    inv = lb.planes_to_ints(F.from_mont(F.batch_inv_mont(F.to_mont(A))))
    assert inv == [pow(x, -1, p) if x else 0 for x in a]
    # int32 storage (the CUDA dtype) gives the same values
    got32 = F.mont_mul(lb.narrow(A, torch.int32), lb.narrow(B, torch.int32))
    assert got32.dtype == torch.int32
    assert lb.planes_to_ints(got32) == lb.planes_to_ints(pairs[3][0])


def test_lazy_values_canonicalise():
    """[0, 2q) representatives (what the kernels hold inside a launch)
    canonicalise to [0, q)."""
    a = sample(Q, 16, seed=4)
    lazy = [x + Q if x < (1 << 256) - Q else x for x in a]
    assert lb.planes_to_ints(fq().canon(lb.ints_to_planes(lazy))) == a


def test_fq2_ops_match_jax():
    F2, JF2 = Fq2Ops(), JFq2Ops()
    a = [lb.ints_to_planes(sample(Q, 16, seed=s)) for s in (5, 6)]
    b = [lb.ints_to_planes(sample(Q, 16, seed=s)) for s in (7, 8)]
    A, B = torch.stack(a), torch.stack(b)
    JA = tuple(jnp.asarray(convert.from_torch(x)) for x in a)
    JB = tuple(jnp.asarray(convert.from_torch(x)) for x in b)
    for got, exp in [(F2.mont_mul(A, B), JF2.mont_mul(JA, JB)),
                     (F2.mont_mul(A, A), JF2.mont_sqr(JA)),
                     (F2.add(A, B), JF2.add(JA, JB)),
                     (F2.sub(A, B), JF2.sub(JA, JB)),
                     (F2.neg(A), JF2.neg(JA))]:
        for k in range(2):
            assert torch.equal(got[k], convert.to_torch(np.asarray(exp[k])))
