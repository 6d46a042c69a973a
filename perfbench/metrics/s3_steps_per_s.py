"""Completed s3 training steps a second over the whole window."""
from perfbench.harness.readers import rate as read  # noqa: F401
