"""Completed s2 iterations a second over the whole window."""
from perfbench.harness.readers import rate as read  # noqa: F401
