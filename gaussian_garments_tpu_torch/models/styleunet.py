"""Style-modulated UNet (SWGAN_unet) as torch modules.

Port of ``gaussian_garments_tpu/models/styleunet.py`` (reference
``scene/styleunet/styleunet.py:634-860``):

- ``fused_bias_act`` → ``leaky_relu(x + b) · √2``;
- ``upfirdn2d`` → zero-insert upsample, pad, and one depthwise ``F.conv2d``
  with the flipped FIR kernel and the downsample stride;
- ModulatedConv2d in the unfused form (modulate the input, plain conv,
  demodulate the output); its upsampling conv is ``F.conv_transpose2d``.

Submodule and parameter names are the Flax names (``style_0``, ``conv_in``,
``from_rgb_0.conv.conv.weight``, ``to_rgb_4.bias``, ...), so a state_dict key
is the Flax parameter path joined with dots. The fixed noise buffers
(``noise_0``...) are buffers, loaded from the checkpoint. The wavelet
``Discriminator`` (with ``DiscFromRGB`` and ``_minibatch_stddev``), which no
stage script trains, is here too. Convolutions are
float32 unless the caller casts the weights and inputs to bf16; the entry
points turn TF32 off (``pin_full_f32``). Every Python constant that scales an
activation or a weight is first rounded to that tensor's dtype (``_c``), as
JAX rounds a weakly typed scalar: in bf16, ``x · √2`` is ``x · 1.4140625``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussian_garments_tpu_torch.utils import logging as log

BLUR = (1, 3, 3, 1)


@functools.lru_cache(maxsize=None)
def _c(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a no-op change for float32)."""
    return torch.tensor(value, dtype=dtype).item()


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, _c(negative_slope, x.dtype)) * _c(scale, x.dtype)


def make_kernel(k) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """(N,C,H,W) upsample-pad-FIR-downsample with the reference's semantics."""
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    px0, px1, py0, py1 = pad
    assert min(pad) >= 0, "negative pads unsupported"
    n, c, h, w = x.shape
    kernel = np.ascontiguousarray(kernel)
    kflip = _flipped_filter(kernel.tobytes(), kernel.dtype.str, kernel.shape, x.dtype, x.device)
    weight = kflip[None, None].expand(c, 1, *kflip.shape).contiguous()
    if up > 1:
        xu = x.new_zeros((n, c, h * up, w * up))
        xu[:, :, ::up, ::up] = x
        x = xu
    x = F.pad(x, (px0, px1, py0, py1))
    return F.conv2d(x, weight, stride=down, groups=c)


@functools.cache
def _flipped_filter(kernel: bytes, np_dtype: str, shape: Tuple[int, int], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``upfirdn2d``'s FIR filter (``kernel``'s bytes, numpy dtype and shape)
    flipped, made once a (filter, dtype, device): the copy from the host
    waits for the stream on a card, and a step under CUDA graph capture
    (``training/s3``) may not copy from the host."""
    k = np.frombuffer(kernel, np_dtype).reshape(shape)
    with log.span("sync"):
        log.count("host_syncs")
        return torch.as_tensor(np.ascontiguousarray(k[::-1, ::-1]), dtype=dtype, device=device)


def _blur_pads(kernel_len: int, kernel_size: int, factor: int, mode: str) -> Tuple[int, int]:
    if mode == "up":
        p = (kernel_len - factor) - (kernel_size - 1)
        return (p + 1) // 2 + factor - 1, p // 2 + 1
    p = (kernel_len - factor) + (kernel_size - 1)
    return (p + 1) // 2, p // 2


def _randn(shape, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


def upsample(x):
    k = make_kernel(BLUR) * 4
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample(x):
    k = make_kernel(BLUR)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), generator) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        dt = self.weight.dtype
        out = x @ (self.weight * _c(self.scale, dt)).T
        if self.bias is not None:
            if self.activation:
                return fused_leaky_relu(out, self.bias * _c(self.lr_mul, dt))
            return out + self.bias * _c(self.lr_mul, dt)
        if self.activation:
            return fused_leaky_relu(out)
        return out


class EqualConv2d(nn.Module):
    def __init__(self, in_c, out_c, kernel_size, stride=1, padding=0, use_bias=True,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_c, in_c, kernel_size, kernel_size), generator))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        out = F.conv2d(x, self.weight * _c(self.scale, self.weight.dtype), stride=self.stride,
                       padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.reshape(1, -1, 1, 1)
        return out


class ModulatedConv2d(nn.Module):
    def __init__(self, in_c, out_c, kernel_size, style_dim, demodulate=True,
                 upsample=False, downsample=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_c, in_c, kernel_size, kernel_size), generator))
        self.modulation = EqualLinear(style_dim, in_c, bias_init=1.0, generator=generator)
        self.scale = 1.0 / math.sqrt(in_c * kernel_size ** 2)
        self.k = kernel_size
        self.demodulate, self.upsample, self.downsample = demodulate, upsample, downsample

    def forward(self, x, style):
        s = self.modulation(style)                                   # (B,in)
        wk = self.weight * _c(self.scale, self.weight.dtype)
        if self.demodulate:
            wmod = wk[None] * s[:, None, :, None, None]
            dcoef = torch.rsqrt(torch.sum(wmod ** 2, dim=(2, 3, 4)) + _c(1e-8, wmod.dtype))
        x = x * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(x, wk.transpose(0, 1), stride=2)
            p0, p1 = _blur_pads(len(BLUR), self.k, 2, "up")
            out = upfirdn2d(out, make_kernel(BLUR) * 4, pad=(p0, p1))
        elif self.downsample:
            p0, p1 = _blur_pads(len(BLUR), self.k, 2, "down")
            out = F.conv2d(upfirdn2d(x, make_kernel(BLUR), pad=(p0, p1)), wk, stride=2)
        else:
            out = F.conv2d(x, wk, padding=self.k // 2)
        if self.demodulate:
            out = out * dcoef[:, :, None, None]
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image, noise):
        return image + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, in_c, out_c, kernel_size, style_dim, upsample=False, demodulate=True,
                 generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_c, out_c, kernel_size, style_dim, demodulate=demodulate,
                                    upsample=upsample, generator=generator)
        self.noise = NoiseInjection()
        self.act_bias = nn.Parameter(torch.zeros(out_c))

    def forward(self, x, style, noise):
        return fused_leaky_relu(self.noise(self.conv(x, style), noise), self.act_bias)


class ConvLayer(nn.Module):
    def __init__(self, in_c, out_c, kernel_size, downsample=False, use_bias=True,
                 activate=True, generator=None):
        super().__init__()
        self.downsample = downsample
        self.kernel_size = kernel_size
        self.conv = EqualConv2d(in_c, out_c, kernel_size, stride=2 if downsample else 1,
                                padding=0 if downsample else kernel_size // 2,
                                use_bias=use_bias and not activate, generator=generator)
        self.activate = activate
        self.act_bias = nn.Parameter(torch.zeros(out_c)) if activate and use_bias else None

    def forward(self, x):
        if self.downsample:
            p0, p1 = _blur_pads(len(BLUR), self.kernel_size, 2, "down")
            x = upfirdn2d(x, make_kernel(BLUR), pad=(p0, p1))
        out = self.conv(x)
        return fused_leaky_relu(out, self.act_bias) if self.activate else out


class ConvBlock(nn.Module):
    def __init__(self, in_c, out_c, generator=None):
        super().__init__()
        self.conv1 = ConvLayer(in_c, in_c, 3, generator=generator)
        self.conv2 = ConvLayer(in_c, out_c, 3, downsample=True, generator=generator)

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _haar_kernels():
    lo = np.ones((1, 2), np.float32) / np.sqrt(2)
    hi = lo.copy()
    hi[0, 0] = -hi[0, 0]
    return lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi  # ll, lh, hl, hh


def haar_transform(x):
    ll, lh, hl, hh = _haar_kernels()
    return torch.cat([upfirdn2d(x, k, down=2) for k in (ll, lh, hl, hh)], dim=1)


def inverse_haar_transform(x):
    ll, lh, hl, hh = _haar_kernels()
    a, b, c, d = torch.chunk(x, 4, dim=1)
    return (upfirdn2d(a, ll, up=2, pad=(1, 0, 1, 0)) + upfirdn2d(b, -lh, up=2, pad=(1, 0, 1, 0))
            + upfirdn2d(c, -hl, up=2, pad=(1, 0, 1, 0)) + upfirdn2d(d, hh, up=2, pad=(1, 0, 1, 0)))


class FromRGB(nn.Module):
    """use_wt=False variant (the only one SWGAN_unet instantiates)."""

    def __init__(self, in_c, out_c, generator=None):
        super().__init__()
        self.conv = ConvLayer(in_c, out_c, 1, generator=generator)

    def forward(self, inp, skip):
        inp = downsample(inp)
        out = self.conv(inp)
        return inp, (out if skip is None else out + skip)


class ToRGB(nn.Module):
    def __init__(self, in_c, out_c, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_c, out_c, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, out_c, 1, 1))

    def forward(self, x, style, skip):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + haar_transform(upsample(inverse_haar_transform(skip)))
        return out


class DiscFromRGB(nn.Module):
    """The Discriminator's FromRGB (``use_wt=True``; JAX
    ``models/styleunet.py:331``): inputs live in Haar-wavelet space, and a
    downsampling level round-trips through pixel space (iwt → blur-down →
    dwt)."""

    def __init__(self, in_c, out_c, downsample=True, generator=None):
        super().__init__()
        self.downsample = downsample
        self.conv = ConvLayer(in_c, out_c, 1, generator=generator)

    def forward(self, inp, skip):
        if self.downsample:
            inp = haar_transform(downsample(inverse_haar_transform(inp)))
        out = self.conv(inp)
        return inp, (out if skip is None else out + skip)


def _minibatch_stddev(out, group_size: int = 4, feat: int = 1):
    """StyleGAN2's minibatch stddev (JAX ``models/styleunet.py:350``): the
    biased per-group feature stddev, averaged, tiled back over the batch."""
    b, c, h, w = out.shape
    g = min(b, group_size)
    s = out.reshape(g, b // g, feat, c // feat, h, w)
    sd = torch.sqrt(s.var(dim=0, unbiased=False) + _c(1e-8, out.dtype))  # (B/g,f,C/f,H,W)
    sd = sd.mean(dim=(2, 3, 4), keepdim=True)[:, :, 0]                   # (B/g,f,1,1)
    return sd.repeat(g, 1, h, w)                                          # (B,f,H,W)


class Discriminator(nn.Module):
    """StyleGAN2 wavelet discriminator (JAX ``models/styleunet.py:361``;
    reference styleunet.py:473-565), with the pose-conditioned projection
    head when ``c_dim > 0``. No stage script trains it."""

    def __init__(self, size, img_channel=6, channel_multiplier=2, c_dim=0, generator=None):
        super().__init__()
        g, cm = generator, channel_multiplier
        self.c_dim = c_dim
        log_size = int(math.log2(size)) - 1
        in_channel = _channels(size, cm)
        self.n_levels = 0
        for j, i in enumerate(range(log_size, 2, -1)):
            out_channel = _channels(2 ** (i - 1), cm)
            setattr(self, f"from_rgb_{j}", DiscFromRGB(img_channel * 4, in_channel,
                                                       downsample=(i != log_size), generator=g))
            setattr(self, f"conv_{j}", ConvBlock(in_channel, out_channel, generator=g))
            in_channel = out_channel
            self.n_levels += 1
        c4 = _channels(4, cm)
        self.from_rgb_final = DiscFromRGB(img_channel * 4, c4, generator=g)
        self.final_conv = ConvLayer(c4 + 1, c4, 3, generator=g)
        self.final_linear_0 = EqualLinear(c4 * 4 * 4, c4, activation="fused_lrelu", generator=g)
        self.final_linear_1 = EqualLinear(c4, 1, generator=g)
        for i in range(4 if c_dim > 0 else 0):
            setattr(self, f"mapping_{i}", EqualLinear(c_dim if i == 0 else 64, 64, lr_mul=0.01,
                                                      activation="fused_lrelu", generator=g))

    def forward(self, x, flat_pose: Optional[torch.Tensor] = None):
        x = haar_transform(x)
        out = None
        for j in range(self.n_levels):
            x, out = getattr(self, f"from_rgb_{j}")(x, out)
            out = getattr(self, f"conv_{j}")(out)
        x, out = self.from_rgb_final(x, out)
        out = torch.cat([out, _minibatch_stddev(out)], dim=1)
        out = self.final_conv(out).reshape(out.shape[0], -1)
        out = self.final_linear_1(self.final_linear_0(out))
        if self.c_dim > 0:
            e = flat_pose
            for i in range(4):
                e = getattr(self, f"mapping_{i}")(e)
            e = e * torch.rsqrt(torch.mean(e ** 2, dim=1, keepdim=True) + _c(1e-8, e.dtype))
            out = torch.sum(out * e, dim=1, keepdim=True) / math.sqrt(self.c_dim)
        return out


_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512}


def _channels(res: int, channel_multiplier: int = 2) -> int:
    base = {64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}
    return _CHANNELS.get(res) or base[res] * channel_multiplier


class SWGANUnet(nn.Module):
    """SWGAN_unet: blurred-downsample condition encoder + StyleGAN2 decoder
    with Haar-wavelet skips. The viewdir feature is added after the level's
    ToRGB at i == 8 (a reference quirk kept verbatim; at ≤512² it does not
    reach the output)."""

    def __init__(self, inp_size, inp_ch, out_ch, out_size, style_dim, n_mlp,
                 middle_size=8, channel_multiplier=2, generator=None):
        super().__init__()
        g = generator
        cm = channel_multiplier
        middle_log = int(math.log2(middle_size))
        log_size = int(math.log2(out_size)) - 1
        self.n_latent = log_size * 2 - (middle_log * 2 - 1) + 1
        self.n_mlp = n_mlp
        num_layers = (log_size - middle_log) * 2
        for i in range(n_mlp):
            setattr(self, f"style_{i}", EqualLinear(style_dim, style_dim, lr_mul=0.01,
                                                    activation="fused_lrelu", generator=g))
        for idx in range(num_layers):
            r = 2 ** ((idx + 2 * (middle_log + 1)) // 2)
            self.register_buffer(f"noise_{idx}", _randn((1, 1, r, r), g))
        self.num_layers = num_layers

        in_channel = _channels(inp_size // 2, cm)
        self.conv_in = ConvLayer(inp_ch, in_channel, 3, downsample=True, generator=g)
        cond_ch = [in_channel]
        self.enc_levels = list(range(int(math.log2(inp_size)) - 2, middle_log - 1, -1))
        for j, i in enumerate(self.enc_levels):
            out_channel = _channels(2 ** i, cm)
            setattr(self, f"from_rgb_{j}", FromRGB(inp_ch, in_channel, generator=g))
            setattr(self, f"cond_conv_{j}", ConvBlock(in_channel, out_channel, generator=g))
            cond_ch.append(out_channel)
            in_channel = out_channel

        n_comb = len(self.enc_levels) + 1
        self.levels = list(range(middle_log + 1, log_size + 1))
        cur = None
        for lvl, res_log in enumerate(self.levels):
            i = 2 * lvl
            out_channel = _channels(2 ** res_log, cm)
            if i == 0:
                cur = cond_ch[-1]
                setattr(self, f"comb_{n_comb - 1}", ConvLayer(cur, cur, 3, generator=g))
            elif i < 2 * n_comb:
                c = cond_ch[-1 - (i // 2)]
                setattr(self, f"comb_{n_comb - 1 - i // 2}", ConvLayer(cur + c, c, 3, generator=g))
                cur = c
            setattr(self, f"conv_{i}", StyledConv(cur, out_channel, 3, style_dim, upsample=True,
                                                  generator=g))
            setattr(self, f"conv_{i + 1}", StyledConv(out_channel, out_channel, 3, style_dim,
                                                      generator=g))
            setattr(self, f"to_rgb_{lvl}", ToRGB(out_channel, out_ch * 4, style_dim, generator=g))
            cur = out_channel
        self.n_comb = n_comb

    def forward(self, style, condition_img, view_feature: Optional[torch.Tensor] = None):
        s = style * torch.rsqrt(torch.mean(style ** 2, dim=1, keepdim=True)
                                + _c(1e-8, style.dtype))                           # PixelNorm
        for i in range(self.n_mlp):
            s = getattr(self, f"style_{i}")(s)
        latent = s[:, None, :].expand(-1, self.n_latent, -1)
        noise = [getattr(self, f"noise_{i}") for i in range(self.num_layers)]

        cond_img = condition_img
        cond_out = self.conv_in(cond_img)
        cond_list = [cond_out]
        for j in range(len(self.enc_levels)):
            cond_img, cond_out = getattr(self, f"from_rgb_{j}")(cond_img, cond_out)
            cond_out = getattr(self, f"cond_conv_{j}")(cond_out)
            cond_list.append(cond_out)

        n_comb = self.n_comb
        skip = out = None
        for lvl in range(len(self.levels)):
            i = 2 * lvl
            if i == 0:
                out = getattr(self, f"comb_{n_comb - 1}")(cond_list[-1])
            elif i < 2 * n_comb:
                out = getattr(self, f"comb_{n_comb - 1 - i // 2}")(
                    torch.cat([out, cond_list[-1 - i // 2]], dim=1))
            out = getattr(self, f"conv_{i}")(out, latent[:, i], noise[i])
            out = getattr(self, f"conv_{i + 1}")(out, latent[:, i + 1], noise[i + 1])
            skip = getattr(self, f"to_rgb_{lvl}")(out, latent[:, i + 2], skip)
            if view_feature is not None and i == 8:
                out = out + F.interpolate(view_feature, size=out.shape[-2:], mode="bilinear",
                                          align_corners=False)
        return inverse_haar_transform(skip)
