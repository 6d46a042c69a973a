"""The s2 iteration's counted FLOPs (the compositing terms of its cameras,
SSIM) over its wall time, taken without the profiler, at the float32 peak."""
from perfbench.harness.readers import mfu_pct as read  # noqa: F401
