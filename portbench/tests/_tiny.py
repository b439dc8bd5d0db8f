"""Tiny deployments for the benchmark's CPU tests: the harness's files
laid out under a temporary folder, found by name as the real ones are."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import bench

CONFIGS = {
    "g16_tiny": {"circuit": "square_chain", "constraints": 24,
                 "log_domain": 5, "key_seed": 7},
    "ug_tiny": {"circuit": "lookup", "table_size": 8, "chunks": 10,
                "log_domain": 5, "key_seed": 9,
                "chunk_values": {"dist": "uniform"}},
}
MIX = {"loop": "closed", "pool": 2, "warmup": 0, "check": 4}
CELLS = {"groth16": ("g16_cell", "g16_tiny"), "ultragroth": ("ug_cell", "ug_tiny")}
REAL_CELLS = ("g16_2p20_serial", "ug_2p20_serial_u16")   # their stand-ins


def layout(tmp: Path) -> tuple[dict, Path]:
    """(a BENCHMARK.json dict, the base folder) with both tiny cells, the
    real caller loops and the real metric readers."""
    base = tmp / "bench"
    (base / "configs").mkdir(parents=True)
    (base / "traffic").mkdir()
    shutil.copytree(bench.HERE / "metrics", base / "metrics")
    shutil.copytree(bench.HERE / "loops", base / "loops",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(MIX))
    real = json.loads((bench.HERE.parent / "BENCHMARK.json").read_text())
    real["workloads"] = [
        {"name": cell, "config": cfg, "traffic": "tiny_mix", "chips": 1,
         "why": "test"} for cell, cfg in CELLS.values()]
    rename = dict(zip(REAL_CELLS, (c for c, _ in CELLS.values())))
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[c] for c in m["workloads"]]
    return real, base
