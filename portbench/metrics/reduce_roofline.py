"""The bucket reductions' and window combines' (`*_reduce_step`,
`*_reduce_tail`, `*_window_combine`) share of their roofline, %."""
from portbench.metrics import _roofline as _rf


def read(ctx):
    return _rf.share(ctx, "reduce", "reduce_step", "reduce_tail",
                     "window_combine")
