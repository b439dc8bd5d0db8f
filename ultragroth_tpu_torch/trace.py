"""In-prover phase timers and cooperative cancel: the twin of the JAX
package's `trace.py`.

Same phase names and the same `last_phase_ms` on the prover.  On a CUDA
device each mark records a CUDA event on the current stream, so timing
adds no synchronisation between phases; `report()` synchronises once and
reads the elapsed time between consecutive events.  On the CPU the marks
read the host clock.

- `abort_check`: a callable polled at every mark; when it returns True the
  mark raises `ProveAborted` (the server's /cancel).  Before each poll the
  current stream is synchronised, so the phase has really ended; only
  when a check is given.
- ULTRAGROTH_TRACE=1 prints one stderr line per phase as it ends (each
  mark then synchronises).
- ULTRAGROTH_PROFILE=<dir> records each prove with `torch.profiler` and
  writes a Chrome trace `<dir>/<label>.json`; each phase is a named range
  (`annotate`).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


def _env_enabled() -> bool:
    return os.environ.get("ULTRAGROTH_TRACE", "") not in ("", "0", "off")


def _profile_dir() -> str | None:
    d = os.environ.get("ULTRAGROTH_PROFILE", "")
    return d if d not in ("", "0", "off") else None


def annotate(name: str):
    """A named range of the profiler trace around one phase; free unless
    ULTRAGROTH_PROFILE is set."""
    if _profile_dir() is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_session(label: str):
    """torch.profiler around a whole prove when ULTRAGROTH_PROFILE is set
    (CPU and, where there is one, CUDA activity); otherwise free."""
    d = _profile_dir()
    if d is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(d, f"{label}.json"))


class ProveAborted(RuntimeError):
    """Raised at a phase mark when the abort_check fires (the cooperative
    in-flight cancel behind the server's /cancel)."""


class Tracer:
    """Named phase marks around the prover pipeline:
    `out = tracer.run("msm_a", fn)` or `tracer.mark("finalize")`."""

    def __init__(self, device, label: str = "prove", abort_check=None,
                 enabled: bool | None = None):
        self.cuda = torch.device(device).type == "cuda"
        self.label = label
        self.abort_check = abort_check
        self.enabled = _env_enabled() if enabled is None else enabled
        self._marks: list[tuple[str, object]] = []
        self._t0 = self._now()

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def run(self, name: str, fn):
        with annotate(f"{self.label}:{name}"):
            out = fn()
        self.mark(name)
        return out

    def mark(self, name: str) -> None:
        prev = self._marks[-1][1] if self._marks else self._t0
        self._marks.append((name, self._now()))
        if self.abort_check is not None:
            if self.cuda:
                torch.cuda.current_stream().synchronize()
            if self.abort_check():
                raise ProveAborted(f"aborted during {self.label}:{name}")
        if self.enabled:
            if self.cuda:
                torch.cuda.current_stream().synchronize()
            print(f"[ultragroth-torch] {self.label} {name}: "
                  f"{self._ms(prev, self._marks[-1][1]):.1f} ms",
                  file=sys.stderr, flush=True)

    def report(self) -> dict[str, float]:
        """{phase: ms}, in order; synchronises the device once."""
        if self.cuda:
            torch.cuda.synchronize()
        phase_ms: dict[str, float] = {}
        prev = self._t0
        for name, t in self._marks:
            phase_ms[name] = phase_ms.get(name, 0.0) + self._ms(prev, t)
            prev = t
        if self.enabled:
            print(f"[ultragroth-torch] {self.label} total: "
                  f"{sum(phase_ms.values()):.1f} ms", file=sys.stderr,
                  flush=True)
        return phase_ms
