"""Device operations launched per report in the traced sub-window."""
from benchmark.yardstick.readers import launches_per_unit as read  # noqa: F401
