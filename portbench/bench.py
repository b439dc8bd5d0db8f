"""One run of one benchmark cell, driven by data.

The cell is an entry of `BENCHMARK.json`'s `workloads`; everything it
names is found by that name under the benchmark's folder:

  configs/<config>.json    the deployment (circuit kind and sizes, key seed)
  traffic/<traffic>.json   the mix, read by `traffic.py`
  loops/<loop>.py          the caller loop a mix names (`loops/__init__.py`)
  metrics/<metric>.py      one reader a metric: read(ctx) -> number | None
  circuits/<kind>.py       the circuit a configuration names

A run: the key from the benchmark's cache (made there once a checkout),
the prover built from its bytes through the library API, the witness pool
and the warm-up proves (set-up), then the mix's callers proving for the
window, then the reference's check of a sample of the window's
proofs, drawn from the seed.  The program under test is the port,
`ultragroth_tpu_torch`, on its defaults; its only other outputs the
benchmark reads are each prove's phase times (`last_phase_ms`) and its
kernel launch counts.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import circuits, keygen, loops, trace, traffic, work
from .reference.prover import ReferenceProver

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ultragroth_tpu")
PROGRAM_SWITCHES = ("ULTRAGROTH_PLATFORM", "ULTRAGROTH_MXU_FIELD",
                    "ULTRAGROTH_FIXED_MSM_MB", "ULTRAGROTH_NTT",
                    "ULTRAGROTH_TRACE", "ULTRAGROTH_PROFILE",
                    "ULTRAGROTH_COORDINATOR")


@dataclass
class Cell:
    name: str
    config: dict
    config_path: Path
    mix: dict
    loop: object           # the mix's caller loop (loops/<loop>.py)
    chips: int
    metrics: list          # the BENCHMARK.json entries this run reports
    base: Path = HERE      # where its files were found


def load_cell(bench: dict, workload: str, trace_on: bool,
              base: Path = HERE) -> Cell:
    entry = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entry) != 1:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = entry[0]
    config_path = base / "configs" / f"{entry['config']}.json"
    config = json.loads(config_path.read_text())
    mix = traffic.validate(json.loads(
        (base / "traffic" / f"{entry['traffic']}.json").read_text()))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    if trace_on:
        metrics = [m for m in bench["per_layer"]
                   if workload in m["workloads"] or
                   ("workloads" not in m and m["moves"] in names)]
    else:
        metrics = e2e
    return Cell(workload, config, config_path, mix,
                loops.find(mix["loop"], base), int(entry["chips"]), metrics,
                base)


def reader(name: str, base: Path = HERE):
    """The reader module of metric `name` (metrics/<name>.py)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def configure_program(cache: Path) -> None:
    """The program on its defaults, its kernels built into the checkout."""
    for k in PROGRAM_SWITCHES:
        os.environ.pop(k, None)
    os.environ["ULTRAGROTH_COMPILE_CACHE"] = str(cache / "kernels")


def make_prover(protocol: str, zkey: bytes, device):
    from ultragroth_tpu_torch import api
    cls = api.Groth16Prover if protocol == "groth16" else api.UltraGrothProver
    return cls(zkey, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check(dep, logs, device, pool, win: loops.Window, mix: dict,
          seed: int, want_work: bool) -> tuple[dict, dict]:
    """The reference's verdict on a sample of the window's proves, drawn
    from the seed: (numbers compared, work bounds a prove)."""
    ref = ReferenceProver(dep, logs, device)
    n = len(win.outputs)
    rng = traffic.stream(seed, "check")
    sample = sorted(rng.sample(range(n), min(int(mix["check"]), n)))
    cache, bounds = {}, []
    wrong = wrong_pub = 0
    for i in sample:
        k, b = win.items[i]
        out = win.outputs[i]
        if out is None:             # failed: counted by proves_failed
            continue
        w = pool[k]
        proof, publics, derived = ref.expected(w.values, w.lookup, b, cache, k)
        wrong += json.loads(out[0]) != proof
        wrong_pub += json.loads(out[1]) != publics
        if want_work and dep.protocol != "groth16":
            bounds.append(work.prove_bounds(dep.sections, derived.scalars))
    per_prove = None
    if want_work:
        if dep.protocol == "groth16":
            by_item = {k: work.prove_bounds(dep.sections, d.scalars)
                       for k, d in cache.items()}
            missing = {k for k, _ in win.items} - set(by_item)
            for k in missing:
                d = ref.groth16_derive(pool[k].values)
                by_item[k] = work.prove_bounds(dep.sections, d.scalars)
            per_prove = [by_item[k] for k, _ in win.items]
        elif bounds:
            mean = {key: statistics.fmean(b[key] for b in bounds)
                    for key in bounds[0]}
            per_prove = [mean] * n
    numbers = {
        "proofs_checked": (len(sample), ">=", 1),
        "proofs_wrong": (wrong, "<=", 0),
        "publics_wrong": (wrong_pub, "<=", 0),
        "proves_failed": (len(win.errors), "<=", 0),
    }
    return numbers, {"per_prove": per_prove}


def holds(value, op, limit) -> bool:
    return value >= limit if op == ">=" else value <= limit


def run(cell: Cell, seed: int, seconds: float, trace_on: bool,
        device="cuda", cache: Path = HERE / "_cache", prover_factory=None,
        log=None) -> dict:
    """One run; returns the result object (the run's last line)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    log(f"host: CPUs {sorted(os.sched_getaffinity(0))} of {os.cpu_count()}")
    kernel_build_s = (load_kernels(log) if on_card and prover_factory is None
                      else 0.0)
    t_key = time.perf_counter()
    age_key = process_age_s()
    cfg = cell.config
    circuit = circuits.kind(cfg["circuit"])
    dep = circuit.build(cfg)
    logs = keygen.key_logs(dep, int(cfg["key_seed"]))
    zkey, key_build_s = keygen.cached_zkey(cache / "keys", cell.config_path,
                                           dep, logs, device)
    log(f"key: {len(zkey)} bytes, built in {key_build_s:.3f} s "
        f"(0: from the cache); process start to key {age_key:.3f} s, key "
        f"{time.perf_counter() - t_key - key_build_s:.3f} s")
    t0 = time.perf_counter()
    if prover_factory is None:
        prover = make_prover(dep.protocol, zkey, device)
    else:
        prover = prover_factory(dep, logs, zkey, device)
    _sync(device)
    key_load_s = time.perf_counter() - t0
    del zkey
    t_pool = time.perf_counter()
    pool = traffic.pool(circuit, dep, cell.mix, seed)
    t_warm = time.perf_counter()
    warm = traffic.blinding(dep.protocol, traffic.stream(seed, "warmup"))
    for i in range(int(cell.mix["warmup"])):
        prover.prove(pool[i % len(pool)].data, **next(warm))
    _sync(device)
    log(f"set-up: prover {key_load_s:.3f} s, witness pool "
        f"{t_warm - t_pool:.3f} s, warm-up proves "
        f"{time.perf_counter() - t_warm:.3f} s")
    setup_s = process_age_s() - key_build_s - kernel_build_s
    kernels = _kernels_module(prover_factory)
    if kernels is not None:
        kernels.reset_launch_counts()
    blind = traffic.blinding(dep.protocol, traffic.stream(seed, "window"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with trace.profiled(trace_on) as prof:
        win = cell.loop.drive(prover, pool, blind, seconds, cell.mix)
        _sync(device)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if kernels is not None:
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        log(f"launches in the window ({len(win.outputs)} proves): "
            f"{json.dumps(counts)}")
    for e in win.errors[:3]:
        log(f"prove failed: {e}")
    lat = np.asarray(win.latencies_s) * 1e3
    phase_names = sorted({k for ph in win.phases for k in ph})
    log("window: {} proves in {:.3f} s; latency ms min {:.1f} p25 {:.1f} "
        "median {:.1f} p75 {:.1f} max {:.1f}; phase means ms {}".format(
            len(lat), win.seconds, lat.min(), *np.percentile(lat, [25, 50, 75]),
            lat.max(), json.dumps({k: round(statistics.fmean(
                ph.get(k, 0.0) for ph in win.phases), 2) for k in phase_names})))
    tr = trace.read(prof) if trace_on else None
    del prover, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, wk = check(dep, logs, device, pool, win, cell.mix, seed,
                        trace_on)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    ctx = dict(window=win, setup_s=setup_s, key_load_s=key_load_s, trace=tr,
               work=wk["per_prove"])
    metrics = {}
    for m in cell.metrics:
        value = reader(m["name"], cell.base).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(holds(*v) for v in numbers.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(win.outputs),
              "failed": len(win.errors), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {k: {"value": v, "holds": op, "limit": lim}
                        for k, (v, op, lim) in numbers.items()}
    return result


def load_kernels(log) -> float:
    """Build (a checkout's first run) or load the port's kernel libraries
    of its default field mode, before the key and the prover, through the
    port's own loader.  Returns the seconds of a build, 0 where every
    library was already built: a checkout's one-time build is kept out of
    `setup_s` as the key's build is, and is printed here instead."""
    from ultragroth_tpu_torch.ops import _build
    stale = [s for s in _build.SOURCES if not _build.library_path(s).exists()]
    t = time.perf_counter()
    _build.load("cios")
    took = time.perf_counter() - t
    log(f"kernels: {len(stale)} of {len(_build.SOURCES)} libraries built; "
        f"built and loaded in {took:.3f} s")
    return took if stale else 0.0


def _kernels_module(prover_factory):
    if prover_factory is not None:
        return None
    from ultragroth_tpu_torch.ops import kernels
    return kernels
