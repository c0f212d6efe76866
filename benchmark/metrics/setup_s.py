"""Set-up seconds: everything before the window (host clock)."""


def read(ctx):
    return ctx["setup_s"]
