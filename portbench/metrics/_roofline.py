"""A kernel group's share of its roofline over the traced window: the
least time the chip could take for the work the window's proves needed
(`work.py`: their nonzero digits, each input byte read once, at the
published H100 peaks) over the device time of the group's kernels."""


def share(ctx, key, *parts):
    tr, per_prove = ctx["trace"], ctx["work"]
    if tr is None or not per_prove:
        return None
    spent = sum(s for name, s in tr.kernel_s.items()
                if any(p in name for p in parts))
    if spent <= 0:
        return None
    return 100.0 * sum(p[key] for p in per_prove) / spent
