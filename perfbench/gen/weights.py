"""Weights and splats drawn from the seed on the device, in a few large
calls: one normal draw for every "normal" leaf, split into the leaves and
scaled by each leaf's std; constants filled."""
from __future__ import annotations

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named use of the seed, so that two
    uses draw independent numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw(spec, seed: int, device, stream: int = 1) -> dict:
    """{name: float32 tensor} for ``spec`` = [(name, shape, (kind, std, value))]."""
    normal = [(n, s, std) for n, s, (kind, std, _) in spec if kind == "normal"]
    total = sum(torch.Size(s).numel() for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device)
    out, off = {}, 0
    for name, shape, std in normal:
        k = torch.Size(shape).numel()
        out[name] = flat[off:off + k].view(shape).mul_(std)
        off += k
    for name, shape, (kind, _, value) in spec:
        if kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
    return {name: out[name] for name, _, _ in spec}


def texel_splats(n: int, sh_degree: int, s: dict, seed: int, device, stream: int = 2) -> dict:
    """The six splat tensors of ``n`` texels: local offsets 0, colours,
    higher SH 0, log-scales, near-identity rotations and opacity logits,
    spread by the configuration's ``splats`` block ``s``."""
    r = torch.randn((n, 11), generator=generator(seed, device, stream),
                    device=device)
    k = (sh_degree + 1) ** 2 - 1
    rot = torch.cat([torch.ones((n, 1), device=device), torch.zeros((n, 3), device=device)], 1)
    return {
        "xyz": torch.zeros((n, 3), device=device),
        "features_dc": (s["dc_mean"] + s["dc_sd"] * r[:, 0:3])[:, None, :].contiguous(),
        "features_rest": torch.zeros((n, k, 3), device=device),
        "scaling": s["log_scale"] + s["log_scale_sd"] * r[:, 3:6],
        "rotation": rot + s["rotation_sd"] * r[:, 6:10],
        "opacity": s["opacity_logit"] + s["opacity_sd"] * r[:, 10:11],
    }
