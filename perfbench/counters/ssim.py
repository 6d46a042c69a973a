"""Frozen FLOP count of the window-11 SSIM of two 3-channel images, for the
step's share of the peak: per pixel, the masking and the three products
(15), the separable blur of 15 maps (15 × 2 passes × 11 taps × 2 = 660) and
the map (45): 720 forward, twice that backward."""
from __future__ import annotations

FWD_PER_PIXEL = 720
BWD_PER_PIXEL = 1440


def flops(width: int, height: int, backward: bool) -> float:
    return width * height * (FWD_PER_PIXEL + (BWD_PER_PIXEL if backward else 0))
