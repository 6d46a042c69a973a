"""The s3 step's counted FLOPs (the net forward and backward from its
shapes, the compositing terms, SSIM) over its wall time, taken without
the profiler, at the float32 peak."""
from perfbench.harness.readers import mfu_pct as read  # noqa: F401
