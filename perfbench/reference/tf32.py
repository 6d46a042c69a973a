"""TF32 as the control computes it: a float32 operand rounded to TF32's 10
explicit mantissa bits (round to nearest, ties to even), its gradient passed
through unchanged. The control applies it to the operands of the products
that TF32 hardware would take but that run here as elementwise ops or
depthwise convolutions (the compositing's conic, opacity, colours and
weights, and the SSIM blur); convolutions and matrix products run in TF32
by the matmul switch (the reference runs them with cuDNN off, as matrix
products)."""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())
