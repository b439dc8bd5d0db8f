"""The benchmark's own device trace of the window (`--trace 1`): one
`torch.profiler` over the whole window, read into kernel time by name,
the device's busy time, and its idle gaps by what the host was doing.

Busy time is the union of every kernel, copy and set on the card within
the window (the window is the `portbench:window` range the harness opens
around its loop).  An idle gap is a stretch of the window with nothing on
the card; it is named by the innermost host range that spans its middle
(an aten op, a CUDA runtime call, or the harness's own `portbench:prove`
when the host runs plain Python inside the program)."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "portbench:window"
PROVE = "portbench:prove"
LABELLED_GAPS = 400          # the longest gaps named (each a host scan)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)     # device op -> seconds
    idle_gaps: list = field(default_factory=list)    # [(host op, seconds)]


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over CPU and CUDA activity, or nothing."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _events(prof):
    """(name, start us, end us, on the device) of every event, from the
    profiler's raw results (building its event tree takes minutes at a
    window's size), without the device-side copies of the host's named
    ranges (`record_function`), which span work but are none."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    marks = {e.name() for e in raw if e.is_user_annotation()}
    return [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3,
             e.device_type() == cuda)
            for e in raw
            # a host range's shadow on the device timeline is no work
            if not (e.device_type() == cuda and
                    (e.is_user_annotation() or e.name() in marks))]


def read(prof) -> Trace:
    events = _events(prof)
    win = [e for e in events if e[0] == WINDOW and not e[3]]
    if not win:
        raise RuntimeError("trace: no window range in the profile")
    w0, w1 = win[0][1], win[0][2]
    dev = [(max(s, w0), min(e, w1), name)
           for name, s, e, on_dev in events if on_dev]
    dev = [d for d in dev if d[1] > d[0]]
    out = Trace(window_s=(w1 - w0) * 1e-6)
    for s, e, name in dev:
        out.kernel_s[name] = out.kernel_s.get(name, 0.0) + (e - s) * 1e-6
    if not dev:
        return out
    dev.sort()
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > w0:
        gaps.append((w0, cur_s))
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    out.busy_s = busy * 1e-6
    out.idle_gaps = _name_gaps(events, gaps)
    return out


def _name_gaps(events, gaps) -> list:
    host = [e for e in events if not e[3] and e[0] != WINDOW]
    starts = np.array([e[1] for e in host], dtype=np.float64)
    ends = np.array([e[2] for e in host], dtype=np.float64)
    by_name: dict = {}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) / 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if hit.size:
            name = host[hit[np.argmin(ends[hit] - starts[hit])]][0]
        else:
            name = "outside any host range"
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def breakdown(tr: Trace) -> dict:
    ops = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
