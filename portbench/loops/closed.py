"""One caller in a closed loop: the next prove is called as soon as the
last one returns, until the window's time is reached; whole proves only.
An application or service proving statement after statement on its card
through the library, and the proof server's one-slot worker."""
from __future__ import annotations

import time
import traceback

import torch

from portbench import trace
from portbench.loops import Window, phases


def drive(prover, pool, blind, seconds: float, mix: dict) -> Window:
    win = Window()
    t0 = time.perf_counter()
    i = 0
    with torch.profiler.record_function(trace.WINDOW):
        while True:
            k, b = i % len(pool), next(blind)
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(trace.PROVE):
                    out = prover.prove(pool[k].data, **b)
            except Exception:                # a failed prove is counted
                win.errors.append(traceback.format_exc(limit=3))
                out = None
            t1 = time.perf_counter()
            win.latencies_s.append(t1 - t)
            win.phases.append(phases(prover))
            win.outputs.append(out)
            win.items.append((k, b))
            i += 1
            if t1 - t0 >= seconds:
                break
    win.seconds = t1 - t0
    return win
