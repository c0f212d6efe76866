"""Device time inside the program's ``llm_prefill`` spans per report, traced sub-window."""
from benchmark.yardstick.readers import stage_ms_per_unit


def read(ctx):
    return stage_ms_per_unit(ctx, "llm_prefill")
