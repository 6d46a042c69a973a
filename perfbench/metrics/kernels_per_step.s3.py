"""Device kernels, copies and sets in the trace a step, s3 cells."""
from perfbench.harness.readers import kernels_per_step as read  # noqa: F401
