"""FLOPs of the appearance net from its shapes: the reference AvatarNet is
run forward (and backward) on the ``meta`` device, every convolution and
matrix product it dispatches is recorded with its shapes, and each is
counted as 2 × multiply-adds:

- a convolution: batch × Cout × Cin/groups × kernel area × output area
  (input area for a transposed one);
- its backward: the same again for the input gradient and for the weight
  gradient, each only where autograd asks for it;
- a matrix product (m×k)(k×n): 2·m·k·n, batched by the batch size.

Elementwise work is not counted."""
from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _conv(x_shape, w_shape, out_shape, transposed: bool) -> int:
    spatial = x_shape[2:] if transposed else out_shape[2:]
    return 2 * x_shape[0] * math.prod(w_shape) * math.prod(spatial)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is aten.convolution.default:
            self.total += _conv(args[0].shape, args[1].shape, out.shape, args[6])
        elif func is aten.convolution_backward.default:
            g, x, w, transposed, mask = args[0], args[1], args[2], args[7], args[10]
            one = _conv(x.shape, w.shape, g.shape, transposed)
            self.total += one * (int(mask[0]) + int(mask[1]))
        elif func in (aten.mm.default, aten.addmm.default):
            a, b = (args[0], args[1]) if func is aten.mm.default else (args[1], args[2])
            self.total += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif func is aten.bmm.default:
            a, b = args[0], args[1]
            self.total += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        return out


@functools.lru_cache(maxsize=None)
def flops(texture_size: int, sh_degree: int, backward: bool) -> int:
    """FLOPs of one forward (and backward) of AvatarNet at this size, with
    the texels of a full texture."""
    from perfbench.reference.styleunet import AvatarNet

    with torch.device("meta"):
        net = AvatarNet(texture_size, sh_degree)
        res = texture_size
        amb, nrm = torch.ones(1, res, res), torch.ones(3, res, res)
        wv = torch.eye(4)
        vd = torch.ones(res * res, 3)
        gs_u = torch.arange(res * res) // res
    count = _Count()
    with count, torch.enable_grad():
        out = net(amb, nrm, wv, vd, gs_u)
        if backward:
            out.sum().backward()
    return count.total
