"""Share of the traced sub-window in which no device operation ran, in %."""
from benchmark.yardstick.readers import idle_percent as read  # noqa: F401
