"""The bucket drains' (`g1_bucket_drain`, `g2_bucket_drain`) share of
their roofline, %."""
from portbench.metrics import _roofline as _rf


def read(ctx):
    return _rf.share(ctx, "drain", "bucket_drain")
