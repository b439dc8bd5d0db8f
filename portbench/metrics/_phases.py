"""Means over the window's proves of the program's phase times
(`last_phase_ms`, CUDA events, one synchronisation a prove)."""
import statistics


def mean_of(ctx, pick):
    vals = [pick(ph) for ph in ctx["window"].phases if ph]
    vals = [v for v in vals if v is not None]
    return statistics.fmean(vals) if vals else None
