"""Share of the traced window in which no kernel, copy or set ran on the
card (union of intervals), s3 cells."""
from perfbench.harness.readers import idle_pct as read  # noqa: F401
