"""Queries answered per second: every query of every call that returned
in the window, over the window's seconds (host clock)."""


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
