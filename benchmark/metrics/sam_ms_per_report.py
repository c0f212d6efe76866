"""Device time inside the program's ``sam`` spans per report, traced sub-window."""
from benchmark.yardstick.readers import stage_ms_per_unit


def read(ctx):
    return stage_ms_per_unit(ctx, "sam")
