"""Least time of the serving path's attention work over its kernels' device time, in %."""
from benchmark.yardstick.readers import roofline_percent

OPS = ("vit_attn", "sam_encoder_attn", "prefill_attn", "decode_window_attn", "decode_attn")


def read(ctx):
    return roofline_percent(ctx, OPS)
