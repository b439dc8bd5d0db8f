"""The share of the traced window in which nothing (no kernel, copy or
set) runs on the card, %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
