"""Frozen count of the compositor's work: bytes and terms that a render's
inputs need, and the least time the card could take for them.

The count is of the work, not of what a kernel does: each input byte read
once and each output byte written once, and the (pixel, splat) terms that
contribute (α ≥ 1/255, power ≤ 0, transmittance before ≥ 1e-4), as
``reference.render.count_terms`` finds them.

- Forward. In: a 10-float record per splat that has a pair (mean 2, conic 3,
  opacity 1, colour 3, depth 1), a 4-byte splat id per pair, a 4-byte range
  per tile. Out: colour 3, depth 1, alpha 1 floats per pixel, and for a
  backward the final transmittance and the last contributing pair (4 + 4 bytes).
- Backward. In: the records, the pair list, the ranges, the forward's 8
  bytes per pixel and the 5-float image gradient per pixel. Out: a 10-float
  gradient record per splat with a pair.
- A term needs one exponential, issued by the special-function units:
  16 a clock per SM (CUDA programming guide, compute capability 9.0),
  132 SMs, 1.98 GHz boost; bytes move at 3.35 TB/s (H100 SXM data sheet).
- FLOPs per term, for the step's share of the peak: 23 forward (offset 2,
  power 9, exp 1, α 1, weight 1, colour 6, alpha 1, transmittance 2) and 46
  backward.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
SFU_OPS_S = 16 * 132 * 1.98e9
RECORD = 10 * 4
FWD_FLOPS_PER_TERM = 23
BWD_FLOPS_PER_TERM = 46


def _least(nbytes: float, terms: float) -> dict:
    return {"bytes": nbytes, "terms": terms,
            "least_s": max(nbytes / HBM_BYTES_S, terms / SFU_OPS_S)}


def forward(c: dict, for_backward: bool) -> dict:
    out_px = 20 + (8 if for_backward else 0)
    return _least(c["splats"] * RECORD + c["pairs"] * 4 + (c["tiles"] + 1) * 4
                  + c["pixels"] * out_px, c["terms"])


def backward(c: dict) -> dict:
    return _least(2 * c["splats"] * RECORD + c["pairs"] * 4 + (c["tiles"] + 1) * 4
                  + c["pixels"] * (8 + 20), c["terms"])


def flops(c: dict, backward: bool) -> float:
    return c["terms"] * (FWD_FLOPS_PER_TERM + (BWD_FLOPS_PER_TERM if backward else 0))
