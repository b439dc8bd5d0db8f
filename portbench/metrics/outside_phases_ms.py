"""The caller's latency of a prove minus the sum of its phases, mean ms:
what runs outside every phase mark (witness parsing, UltraGroth's final
witness back to Python ints, the JSON)."""
import statistics


def read(ctx):
    win = ctx["window"]
    vals = [lat * 1e3 - sum(ph.values())
            for lat, ph in zip(win.latencies_s, win.phases) if ph]
    return statistics.fmean(vals) if vals else None
