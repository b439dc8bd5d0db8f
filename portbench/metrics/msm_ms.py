"""The MSM phases (`msm_*`, and UltraGroth's `round0_commit`, which also
holds the witness upload), summed a prove, mean ms."""
from portbench.metrics import _phases as _ph


def read(ctx):
    return _ph.mean_of(ctx, lambda ph: sum(
        v for k, v in ph.items()
        if k.startswith("msm_") or k == "round0_commit"))
