"""In-prover phase timers, the twin of the JAX package's `trace.py`.

Same phase names and the same `last_phase_ms` on the prover.  On a CUDA
device each mark records a CUDA event on the current stream, so timing
adds no synchronisation between phases; `report()` synchronises once and
reads the elapsed time between consecutive events.  On the CPU the marks
read the host clock.
"""
from __future__ import annotations

import time

import torch


class Tracer:
    """Named phase marks around the prover pipeline:
    `out = tracer.run("msm_a", fn)` or `tracer.mark("finalize")`."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: list[tuple[str, object]] = []
        self._t0 = self._now()

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def run(self, name: str, fn):
        out = fn()
        self.mark(name)
        return out

    def mark(self, name: str) -> None:
        self._marks.append((name, self._now()))

    def report(self) -> dict[str, float]:
        """{phase: ms}, in order; synchronises the device once."""
        if self.cuda:
            torch.cuda.synchronize()
        phase_ms: dict[str, float] = {}
        prev = self._t0
        for name, t in self._marks:
            ms = prev.elapsed_time(t) if self.cuda else (t - prev) * 1e3
            phase_ms[name] = phase_ms.get(name, 0.0) + ms
            prev = t
        return phase_ms
