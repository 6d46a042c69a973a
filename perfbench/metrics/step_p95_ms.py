"""95th percentile of the wall time of every step in the window, each
ended by a synchronize."""
from perfbench.harness.readers import p95_ms as read  # noqa: F401
