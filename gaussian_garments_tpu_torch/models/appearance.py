"""Fourier positional embedder and the two small appearance nets.

Port of ``gaussian_garments_tpu/models/appearance.py`` (reference
``scene/appearance.py``): ``Embedder``/``get_embedder`` (``:17``, ``:38``),
which AvatarNet constructs and never uses, and ``AppearanceNet`` (``:43``)
and ``ConvUNet`` (``:56``), which no stage script runs.

Submodule names follow Flax's automatic names (``Dense_0``, ``Conv_0``...),
so a state_dict key is the Flax path joined with dots;
``training/checkpoints.py::torch_state_from_flax`` transposes the kernels.
Two Flax semantics are kept: ``nn.Conv(strides=2)`` pads ``SAME``, which for a
3×3 kernel on an even input is (0, 1) rather than (1, 1); and
``jax.image.resize(..., "nearest")`` samples at half-pixel centres, which is
``F.interpolate(mode="nearest-exact")``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Embedder:
    """[x, sin(2^k x), cos(2^k x), ...] for k < num_freqs."""

    def __init__(self, input_dim: int, num_freqs: int = 10, include_input: bool = True):
        self.input_dim = input_dim
        self.include_input = include_input
        self.freq_bands = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs)
        self.out_dim = input_dim * (int(include_input) + 2 * num_freqs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x] if self.include_input else []
        for f in self.freq_bands.tolist():
            outs += [torch.sin(x * f), torch.cos(x * f)]
        return torch.cat(outs, dim=-1)


def get_embedder(input_dim: int, num_freqs: int = 10):
    e = Embedder(input_dim, num_freqs)
    return e, e.out_dim


class AppearanceNet(nn.Module):
    """MLP head: ReLU after each hidden layer, a linear output."""

    def __init__(self, in_dim: int, out_dim: int = 3, hidden: Sequence[int] = (256, 256, 256)):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        for i in range(len(dims) - 1):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_layers = len(dims) - 1

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


class _SameConv(nn.Conv2d):
    """3×3 conv with Flax's ``SAME`` padding: (1, 1) at stride 1; at stride 2
    the total padding is ``max(3 - (n - 1) % 2 - 1, 0)`` split low-first, so
    (0, 1) on an even side and (1, 1) on an odd one."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1):
        super().__init__(in_c, out_c, 3, stride=stride, padding=0)

    def forward(self, x):
        pads = []
        for n in (x.shape[-1], x.shape[-2]):           # F.pad order: W then H
            out = -(-n // self.stride[0])
            total = max((out - 1) * self.stride[0] + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class ConvUNet(nn.Module):
    """Small conv UNet, NCHW in and out: two stride-2 encoder levels, nearest
    upsampling with skip concatenation back up."""

    def __init__(self, in_ch: int, out_ch: int = 3, base: int = 32):
        super().__init__()
        chans = [(in_ch, base, 1), (base, base * 2, 2), (base * 2, base * 4, 2),
                 (base * 6, base * 2, 1), (base * 3, base, 1), (base, out_ch, 1)]
        for i, (ci, co, s) in enumerate(chans):
            setattr(self, f"Conv_{i}", _SameConv(ci, co, stride=s))

    def forward(self, x):
        up = lambda y, like: F.interpolate(y, size=like.shape[-2:], mode="nearest-exact")
        e1 = F.relu(self.Conv_0(x))
        e2 = F.relu(self.Conv_1(e1))
        e3 = F.relu(self.Conv_2(e2))
        d2 = F.relu(self.Conv_3(torch.cat([up(e3, e2), e2], 1)))
        d1 = F.relu(self.Conv_4(torch.cat([up(d2, e1), e1], 1)))
        return self.Conv_5(d1)
