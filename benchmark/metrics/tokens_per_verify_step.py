"""Tokens committed per row and verify step over the window (the decoder's own counts)."""


def read(ctx):
    return ctx["workload"].spec_tokens_per_step(ctx["records"])
