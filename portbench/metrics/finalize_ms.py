"""The `finalize` phase (the host's blinding algebra), mean ms a prove."""
from portbench.metrics import _phases as _ph


def read(ctx):
    return _ph.mean_of(ctx, lambda ph: ph.get("finalize"))
