"""Proves completed in the window over the window's seconds (host clock:
the first timed prove's call to the last prove's return)."""


def read(ctx):
    win = ctx["window"]
    done = sum(out is not None for out in win.outputs)
    return done / win.seconds if win.seconds > 0 else None
