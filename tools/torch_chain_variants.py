"""Time the port's per-key point chains (csrc/chains.cuh: the fixed-base
ladder and the fixed-base window table) on one CUDA card: against the path
they replace, and against the other choices of their design.

    python3 tools/torch_chain_variants.py [--parent DIR] [--variants]

--parent DIR: DIR holds a checkout of the port from before the chains
(`git archive` of that commit), whose set-up ran 32 `curve_madd_valid`
launches a run and whose tables `curve_add_where(P, P)` launches, each
path ending in the plain to-affine.  Each side runs in a subprocess of its
own (the two packages never share a process), in turns: parent, this
tree, this tree, parent.  A side times, at the shapes of a 2^20 key:

  add_where_ms  one `curve_add_where(P, P)` launch over 2^20 lanes, the
                earlier table build's step (CUDA events, 20 launches);
  fb_run_s      one fixed-base set-up run (`testkit/dsetup.py:_fb_run`)
                of 2^20 random canonical scalars, the window table built
                before the clock starts;
  table_s       one fixed-base table (`ops/msm.py:msm_fixed_table`) of
                2^20 points at c = 17 (15 windows), the points the set-up
                window table's finite entries repeated;

each G1 and G2 (seconds: host clock, the device synchronised), and a
checksum of each output, held equal across the sides.

--variants: the shipped chains (cios build) against builds of copies of
csrc/ with other design choices (VARIANTS): `per_lane_fermat`, each lane
inverting its own zz * zzz (its norm, G2) by a Fermat chain, no product
tree; `block_256`, 256 threads a block, one inversion for 256 lanes;
`inline_product` (G1), the Fq product inlined at every call site (the
G2 chains keep theirs out of line: one G2 lane's add does not fit in a
thread's registers inlined).  Each
output held equal to the shipped build's; timed in turns (shipped,
variant, variant, shipped) with CUDA events at 2^20 lanes (the table at
c = 17).  Prints each build's registers, local (spill) bytes and blocks
per SM.  The builds: tools/torch_variants.py.

Prints the card and torch first.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017
LANES = 1 << 20
C = 17

# name: (groups, changes)
VARIANTS = {
    "shipped": (("g1", "g2"), []),
    "per_lane_fermat": (("g1", "g2"), [
        ("chains.cuh", "for (int m = NT / 2; m >= 1; m >>= 1)",
         "for (int m = 0; m >= 1; m >>= 1)"),
        ("chains.cuh", "const fe v = B::inv(sm->tree[1]);",
         "const fe v = B::zero();"),
        ("chains.cuh", "for (int m = 2; m < NT; m <<= 1)",
         "for (int m = NT; m < NT; m <<= 1)"),
        ("chains.cuh", "const fe li = B::mul(sm->inv[k >> 1], sm->tree[k ^ 1]);",
         "const fe li = B::inv(sm->tree[k]);"),
    ]),
    "block_256": (("g1", "g2"), [
        ("chains.cuh", "constexpr int kChainThreads = 128;",
         "constexpr int kChainThreads = 256;"),
    ]),
    "inline_product": (("g1",), [
        ("g1_kernels.cu", "#define UG_CHAIN_F ug::FqCall\n",
         "#define UG_CHAIN_F ug::Fq\n"),
    ]),
}


def _checksum(t: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's words, on the device."""
    v = t.reshape(-1).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 1000003 + 1
    return int((v * w).sum())


def _inputs(dev, group):
    """(window table, flags, 2^20 canonical scalars [8, n] int32, 2^20
    points [n, 2, *elem] int32) from the seed."""
    from ultragroth_tpu_torch.constants import FR_MODULUS as R
    from ultragroth_tpu_torch.ops import limbs as lb
    from ultragroth_tpu_torch.ops.curve import table_from_planes
    from ultragroth_tpu_torch.testkit.dsetup import _fb_table
    table, tinf = _fb_table(group, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sc = torch.randint(0, 1 << 32, (8, LANES), generator=gen, device=dev,
                       dtype=torch.int64)
    sc[7] %= lb.int_to_limbs(R)[7]
    pts = table_from_planes(table)[~tinf]
    pts = pts.repeat(LANES // pts.shape[0] + 1, *([1] * (pts.dim() - 1)))
    return table, tinf, lb.narrow(sc, torch.int32).contiguous(), \
        pts[:LANES].contiguous()


def side() -> int:
    """One side of --parent, in its own process: the package found first
    on PYTHONPATH (the parent checkout's, or this tree's)."""
    from ultragroth_tpu_torch.ops import _build, kernels as K
    from ultragroth_tpu_torch.ops import msm as M
    from ultragroth_tpu_torch.ops.curve import curve_ops, table_planes
    from ultragroth_tpu_torch.testkit import dsetup as D
    dev = torch.device("cuda")
    _build.load("cios")
    out = {"package": os.path.dirname(K.__file__)}
    for g in ("g1", "g2"):
        table, tinf, sc, pts = _inputs(dev, g)
        ops = curve_ops(g)
        planes = table_planes(pts)
        p = ops.affine_to_xyzz(planes[0], planes[1],
                               torch.zeros(LANES, dtype=torch.bool, device=dev))
        p = p.contiguous()
        K.curve_add_where(g, p, p)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            K.curve_add_where(g, p, p)
        end.record()
        torch.cuda.synchronize()
        out[f"{g}_add_where_ms"] = start.elapsed_time(end) / 20
        del p
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y, inf = D._fb_run(g, sc, dev)
        torch.cuda.synchronize()
        out[f"{g}_fb_run_s"] = time.perf_counter() - t0
        out[f"{g}_fb_run_sum"] = [_checksum(x), _checksum(y), _checksum(inf)]
        del x, y, inf
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab, _, _ = M.msm_fixed_table(g, pts, torch.zeros(
            LANES, dtype=torch.bool, device=dev), C)
        torch.cuda.synchronize()
        out[f"{g}_table_s"] = time.perf_counter() - t0
        out[f"{g}_table_sum"] = _checksum(tab)
        del tab, table, tinf, sc, pts
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def parent_turns(parent_dir: str) -> None:
    """parent, this tree, this tree, parent: each a subprocess."""
    root = os.path.dirname(HERE)
    sides = {"parent": os.path.abspath(parent_dir), "tree": root}
    results = {"parent": [], "tree": []}
    for name in ("parent", "tree", "tree", "parent"):
        env = dict(os.environ, PYTHONPATH=sides[name])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--side"], env=env, cwd=sides[name],
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} side failed:\n{proc.stdout}\n"
                               f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if not res["package"].startswith(sides[name]):
            raise RuntimeError(f"{name} side imported {res['package']}")
        results[name].append(res)
        print(f"{name}: " + json.dumps({k: v for k, v in res.items()
                                         if not k.endswith("_sum")}),
              flush=True)
    for g in ("g1", "g2"):
        for key in (f"{g}_fb_run_sum", f"{g}_table_sum"):
            vals = {json.dumps(r[key]) for rs in results.values() for r in rs}
            if len(vals) != 1:
                raise RuntimeError(f"{key} differs across the sides: {vals}")
        line = []
        for key in ("add_where_ms", "fb_run_s", "table_s"):
            mean = {n: sum(r[f"{g}_{key}"] for r in rs) / len(rs)
                    for n, rs in results.items()}
            line.append(f"{key} parent {mean['parent']:.4f} tree "
                        f"{mean['tree']:.4f}")
        print(f"{g}: " + "; ".join(line) + " (outputs equal)", flush=True)


def variant_turns() -> None:
    import torch_variants as V
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ug_chain_variants_") as tmp:
        jobs = {}
        for name, (groups, changes) in VARIANTS.items():
            for g in groups:
                d = V.patched_csrc(tmp, f"{g}_{name}", changes)
                jobs[(g, name)] = (os.path.join(tmp, f"{g}_{name}.so"),
                                   os.path.join(d, f"{g}_kernels.cu"), [])
        libs = {key: V.bind(lib, f"ug_{key[0]}_fixed_base_mul",
                            f"ug_{key[0]}_window_table", f"ug_{key[0]}_chain_info")
                for key, (lib, _) in V.build(jobs).items()}
        from chip_smoke import cuda_time_ms
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for g in ("g1", "g2"):
            table, tinf, sc, pts = _inputs(dev, g)
            e = tuple(pts.shape[2:-1])
            inf = torch.zeros(LANES, dtype=torch.bool, device=dev)
            nw = -(-254 // C)
            tab = torch.zeros((nw * LANES, *pts.shape[1:]), dtype=torch.int32,
                              device=dev)
            tab[:LANES] = pts
            xy = torch.empty((2, *e, 8, LANES), dtype=torch.int32, device=dev)
            xinf = torch.empty(LANES, dtype=torch.bool, device=dev)

            def ladder(lib):
                rc = getattr(lib, f"ug_{g}_fixed_base_mul")(
                    table.data_ptr(), tinf.data_ptr(), table.shape[-1],
                    sc.data_ptr(), xy.data_ptr(), xinf.data_ptr(), LANES,
                    stream())
                if rc:
                    raise RuntimeError(f"{g} fixed_base_mul: CUDA error {rc}")

            def windows(lib):
                rc = getattr(lib, f"ug_{g}_window_table")(
                    tab.data_ptr(), inf.data_ptr(), tab.data_ptr(), LANES, C,
                    nw, stream())
                if rc:
                    raise RuntimeError(f"{g} window_table: CUDA error {rc}")

            want = {}
            for name, (groups, _) in VARIANTS.items():
                if g not in groups:
                    continue
                lib = libs[(g, name)]
                info = []
                for kind in (0, 1):
                    v = [ctypes.c_int(0) for _ in range(3)]
                    getattr(lib, f"ug_{g}_chain_info")(
                        kind, *(ctypes.byref(x) for x in v))
                    info.append("/".join(str(x.value) for x in v))
                ladder(lib)
                windows(lib)
                sums = (_checksum(xy), _checksum(xinf), _checksum(tab))
                want.setdefault("sums", sums)
                if sums != want["sums"]:
                    raise RuntimeError(f"{g} {name}: outputs differ from the "
                                       "shipped build's")
                line = [f"{g} {name}: registers/local B/blocks per SM "
                        f"ladder {info[0]}, table {info[1]}"]
                ship = libs[(g, "shipped")]
                for kind, fn, reps in (("fixed_base_mul", ladder, 5),
                                       ("window_table", windows, 2)):
                    ms = [cuda_time_ms(lambda l=l: fn(l), reps)
                          for l in (ship, lib, lib, ship)]
                    line.append(f"{kind} {(ms[1] + ms[2]) / 2:.4f} ms (shipped "
                                f"{(ms[0] + ms[3]) / 2:.4f} in turn)")
                print("; ".join(line), flush=True)
            del table, tinf, sc, pts, tab, xy, xinf
            torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_chain_variants: no CUDA device", file=sys.stderr)
        return 1
    if args == ["--side"]:
        return side()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch_variants as V
    print(V.card(), flush=True)
    if "--parent" in args:
        parent_turns(args[args.index("--parent") + 1])
    if "--variants" in args or "--parent" not in args:
        variant_turns()
    return 0


if __name__ == "__main__":
    sys.exit(main())
