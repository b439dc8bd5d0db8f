"""The 95th percentile of every prove latency of the window, as the
caller sees it: host clock from the call to the return of `prove`."""
import numpy as np


def read(ctx):
    lat = ctx["window"].latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
