"""Model FLOPs of the window's reports over its wall time, in % of the bf16 peak."""
from benchmark.yardstick.readers import mfu_percent as read  # noqa: F401
