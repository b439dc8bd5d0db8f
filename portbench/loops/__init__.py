"""Caller loops: how a traffic mix's callers send their proves.  Each
loop is a module of its own, `loops/<loop>.py`, named by a mix's `loop`
key and found by that name, with

  drive(prover, pool, blind, seconds, mix) -> Window

prover: the program's prover built in set-up; pool: the mix's witnesses
(`circuits.Witness`); blind: an endless iterator of per-prove blinding
scalars; seconds: the window's length; mix: the mix's parameters, for
keys of the loop's own.  A new loop is a new file here and a mix that
names it; nothing else changes."""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Window:
    """What the window's proves gave, one entry a prove, in call order."""
    latencies_s: list = field(default_factory=list)
    phases: list = field(default_factory=list)    # the prove's phase ms
    outputs: list = field(default_factory=list)   # (proof, publics) | None
    items: list = field(default_factory=list)     # (pool index, blinding)
    errors: list = field(default_factory=list)
    seconds: float = 0.0


def phases(prover) -> dict:
    """The phase times (ms) of the prover's last prove (`last_phase_ms`)."""
    ph = getattr(getattr(prover, "_prover", None), "last_phase_ms", None)
    return dict(ph) if ph else {}


def find(name: str, base: Path):
    """The module of loop `name` (<base>/loops/<name>.py)."""
    path = base / "loops" / f"{name}.py"
    if not str(name).isidentifier() or not path.is_file():
        raise ValueError(f"traffic: no loop {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_loop_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
