"""Plain reference of the appearance net AvatarNet(texture, SH degree): a
frozen copy, in float32 torch, of the published StyleUNet (SWGAN_unet of
Gaussian Garments, arXiv:2409.08189, ``scene/styleunet/styleunet.py`` and
``scene/avatar_net.py``).

Parameter names follow the published layout (``shadow_net.conv_0.conv.weight``,
``viewdir_net.conv0_w``, buffers ``shadow_net.noise_0`` ...), so one state
dict made by the benchmark loads into this module and into the program's.
Each parameter's ``init`` (``init_spec``) says how the benchmark draws it.

Quirks of the published code kept: the (u, u) scatter of the view
directions, the camera-space normal as Rᵀ·n, and the view feature added after
the level's ToRGB at i == 8 (it does not reach the output at 512²).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLUR = (1, 3, 3, 1)
SQRT2 = 2 ** 0.5


def fused_leaky_relu(x, bias=None):
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, 0.2) * SQRT2


def make_kernel(k) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x, kernel: np.ndarray, up: int = 1, down: int = 1, pad=(0, 0)):
    """Upsample by zero insertion, pad, FIR filter (the flipped kernel as a
    depthwise convolution), downsample by stride."""
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    n, c, h, w = x.shape
    kflip = torch.as_tensor(np.ascontiguousarray(kernel[::-1, ::-1]), dtype=x.dtype,
                            device=x.device)
    weight = kflip[None, None].expand(c, 1, *kflip.shape).contiguous()
    if up > 1:
        xu = x.new_zeros((n, c, h * up, w * up))
        xu[:, :, ::up, ::up] = x
        x = xu
    x = F.pad(x, pad)
    return F.conv2d(x, weight, stride=down, groups=c)


def _blur_pads(kernel_len, kernel_size, factor, mode):
    if mode == "up":
        p = (kernel_len - factor) - (kernel_size - 1)
        return (p + 1) // 2 + factor - 1, p // 2 + 1
    p = (kernel_len - factor) + (kernel_size - 1)
    return (p + 1) // 2, p // 2


def upsample(x):
    k = make_kernel(BLUR) * 4
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample(x):
    k = make_kernel(BLUR)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


def _param(shape, init, std=1.0, value=0.0):
    p = nn.Parameter(torch.empty(shape))
    p.init = (init, std, value)
    return p


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias_init=0.0, lr_mul=1.0, activation=False):
        super().__init__()
        self.weight = _param((out_dim, in_dim), "normal", 1.0 / lr_mul)
        self.bias = _param((out_dim,), "const", value=bias_init)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = x @ (self.weight * self.scale).T
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.weight = _param((out_c, in_c, k, k), "normal")
        self.scale = 1.0 / math.sqrt(in_c * k ** 2)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, stride=self.stride, padding=self.padding)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_c, out_c, k, style_dim, demodulate=True, upsample=False):
        super().__init__()
        self.weight = _param((out_c, in_c, k, k), "normal")
        self.modulation = EqualLinear(style_dim, in_c, bias_init=1.0)
        self.scale = 1.0 / math.sqrt(in_c * k ** 2)
        self.k = k
        self.demodulate, self.upsample = demodulate, upsample

    def forward(self, x, style):
        s = self.modulation(style)
        wk = self.weight * self.scale
        if self.demodulate:
            wmod = wk[None] * s[:, None, :, None, None]
            dcoef = torch.rsqrt(torch.sum(wmod ** 2, dim=(2, 3, 4)) + 1e-8)
        x = x * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(x, wk.transpose(0, 1), stride=2)
            out = upfirdn2d(out, make_kernel(BLUR) * 4, pad=_blur_pads(len(BLUR), self.k, 2, "up"))
        else:
            out = F.conv2d(x, wk, padding=self.k // 2)
        if self.demodulate:
            out = out * dcoef[:, :, None, None]
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = _param((1,), "const")

    def forward(self, image, noise):
        return image + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, in_c, out_c, k, style_dim, upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(in_c, out_c, k, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.act_bias = _param((out_c,), "const")

    def forward(self, x, style, noise):
        return fused_leaky_relu(self.noise(self.conv(x, style), noise), self.act_bias)


class ConvLayer(nn.Module):
    """Optional blurred downsample, equalised conv (no bias), bias + leaky ReLU."""

    def __init__(self, in_c, out_c, k, downsample=False):
        super().__init__()
        self.downsample, self.k = downsample, k
        self.conv = EqualConv2d(in_c, out_c, k, stride=2 if downsample else 1,
                                padding=0 if downsample else k // 2)
        self.act_bias = _param((out_c,), "const")

    def forward(self, x):
        if self.downsample:
            x = upfirdn2d(x, make_kernel(BLUR), pad=_blur_pads(len(BLUR), self.k, 2, "down"))
        return fused_leaky_relu(self.conv(x), self.act_bias)


class ConvBlock(nn.Module):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.conv1 = ConvLayer(in_c, in_c, 3)
        self.conv2 = ConvLayer(in_c, out_c, 3, downsample=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _haar_kernels():
    lo = np.ones((1, 2), np.float32) / np.sqrt(2)
    hi = lo.copy()
    hi[0, 0] = -hi[0, 0]
    return lo.T @ lo, hi.T @ lo, lo.T @ hi, hi.T @ hi


def haar_transform(x):
    return torch.cat([upfirdn2d(x, k, down=2) for k in _haar_kernels()], dim=1)


def inverse_haar_transform(x):
    ll, lh, hl, hh = _haar_kernels()
    a, b, c, d = torch.chunk(x, 4, dim=1)
    pad = (1, 0, 1, 0)
    return (upfirdn2d(a, ll, up=2, pad=pad) + upfirdn2d(b, -lh, up=2, pad=pad)
            + upfirdn2d(c, -hl, up=2, pad=pad) + upfirdn2d(d, hh, up=2, pad=pad))


class FromRGB(nn.Module):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.conv = ConvLayer(in_c, out_c, 1)

    def forward(self, inp, skip):
        inp = downsample(inp)
        out = self.conv(inp)
        return inp, (out if skip is None else out + skip)


class ToRGB(nn.Module):
    def __init__(self, in_c, out_c, style_dim):
        super().__init__()
        self.conv = ModulatedConv2d(in_c, out_c, 1, style_dim, demodulate=False)
        self.bias = _param((1, out_c, 1, 1), "const")

    def forward(self, x, style, skip):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + haar_transform(upsample(inverse_haar_transform(skip)))
        return out


def channels(res: int) -> int:
    return {4: 512, 8: 512, 16: 512, 32: 512}.get(res) or {
        64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}[res] * 2


class SWGANUnet(nn.Module):
    def __init__(self, inp_size, inp_ch, out_ch, out_size, style_dim, n_mlp, middle_size=8):
        super().__init__()
        middle_log = int(math.log2(middle_size))
        log_size = int(math.log2(out_size)) - 1
        self.n_latent = log_size * 2 - (middle_log * 2 - 1) + 1
        self.n_mlp = n_mlp
        self.num_layers = (log_size - middle_log) * 2
        for i in range(n_mlp):
            setattr(self, f"style_{i}", EqualLinear(style_dim, style_dim, lr_mul=0.01,
                                                    activation=True))
        for idx in range(self.num_layers):
            r = 2 ** ((idx + 2 * (middle_log + 1)) // 2)
            self.register_buffer(f"noise_{idx}", torch.empty((1, 1, r, r)))
        in_channel = channels(inp_size // 2)
        self.conv_in = ConvLayer(inp_ch, in_channel, 3, downsample=True)
        cond_ch = [in_channel]
        self.enc_levels = list(range(int(math.log2(inp_size)) - 2, middle_log - 1, -1))
        for j, i in enumerate(self.enc_levels):
            out_channel = channels(2 ** i)
            setattr(self, f"from_rgb_{j}", FromRGB(inp_ch, in_channel))
            setattr(self, f"cond_conv_{j}", ConvBlock(in_channel, out_channel))
            cond_ch.append(out_channel)
            in_channel = out_channel
        n_comb = len(self.enc_levels) + 1
        self.levels = list(range(middle_log + 1, log_size + 1))
        cur = None
        for lvl, res_log in enumerate(self.levels):
            i = 2 * lvl
            out_channel = channels(2 ** res_log)
            if i == 0:
                cur = cond_ch[-1]
                setattr(self, f"comb_{n_comb - 1}", ConvLayer(cur, cur, 3))
            elif i < 2 * n_comb:
                c = cond_ch[-1 - (i // 2)]
                setattr(self, f"comb_{n_comb - 1 - i // 2}", ConvLayer(cur + c, c, 3))
                cur = c
            setattr(self, f"conv_{i}", StyledConv(cur, out_channel, 3, style_dim, upsample=True))
            setattr(self, f"conv_{i + 1}", StyledConv(out_channel, out_channel, 3, style_dim))
            setattr(self, f"to_rgb_{lvl}", ToRGB(out_channel, out_ch * 4, style_dim))
            cur = out_channel
        self.n_comb = n_comb

    def forward(self, style, condition_img, view_feature=None):
        s = style * torch.rsqrt(torch.mean(style ** 2, dim=1, keepdim=True) + 1e-8)
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


class ViewdirNet(nn.Module):
    """Conv(3→64, k4 s2 p1) → LeakyReLU(0.2) → Conv(64→128, k4 s2 p1)."""

    def __init__(self):
        super().__init__()
        for name, (o, i) in (("conv0", (64, 3)), ("conv1", (128, 64))):
            setattr(self, f"{name}_w", _param((o, i, 4, 4), "normal", (2.0 / (i * 16)) ** 0.5))
            setattr(self, f"{name}_b", _param((o,), "const"))

    def forward(self, x):
        x = F.leaky_relu(F.conv2d(x, self.conv0_w, self.conv0_b, stride=2, padding=1), 0.2)
        return F.conv2d(x, self.conv1_w, self.conv1_b, stride=2, padding=1)


class AvatarNet(nn.Module):
    def __init__(self, texture_size: int, sh_degree: int):
        super().__init__()
        self.texture_size = texture_size
        self.shadow_net = SWGANUnet(texture_size, 4, (sh_degree + 1) ** 2 * 3 + 3, texture_size,
                                    texture_size, 2)
        self.viewdir_net = ViewdirNet()

    def forward(self, ambient, normal, world_view, local_viewdir, gs_u):
        """Raw (C_out, res, res) output from the AO (1,res,res) and
        object-space normal (3,res,res) textures; ``local_viewdir`` (G,3) is
        each texel's view direction in its face frame, ``gs_u`` its row."""
        res = self.texture_size
        valid = (normal.sum(0, keepdim=True) > 0).to(torch.float32)
        nw_pad = torch.cat([normal * 2 - 1, normal.new_ones((1, res, res))], dim=0) * valid
        nc = torch.einsum("ab,bcd->acd", world_view, nw_pad)[:3]
        nc = nc / torch.clamp(torch.linalg.norm(nc, dim=0, keepdim=True), min=1e-12)
        uu = gs_u * res + gs_u
        vd = local_viewdir.new_zeros((res * res + 1, 3))
        vd[uu] = local_viewdir
        viewdir_map = vd[:res * res].reshape(res, res, 3).permute(2, 0, 1)
        view_feature = self.viewdir_net(viewdir_map[None])
        style = ambient.new_ones((1, res)) / float(res) ** 0.5
        combined = torch.cat([ambient, nc], dim=0)[None]
        return self.shadow_net(style, combined, view_feature=view_feature)[0]


def init_spec(net: nn.Module):
    """[(name, shape, (kind, std, value))] of every parameter and buffer, in
    ``state_dict`` order: kind "normal" draws N(0, std²), "const" fills value;
    the noise buffers are N(0, 1)."""
    spec = []
    for name, p in net.named_parameters():
        spec.append((name, tuple(p.shape), p.init))
    for name, b in net.named_buffers():
        spec.append((name, tuple(b.shape), ("normal", 1.0, 0.0)))
    return spec
