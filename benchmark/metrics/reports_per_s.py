"""Grounded reports (text and masks) completed over the window's wall time."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
