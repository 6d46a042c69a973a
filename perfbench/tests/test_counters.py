"""The frozen counters, checked by hand and against torch's own FLOP
counter."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counters import composite, ssim, styleunet
from perfbench.reference import render as R


def test_styleunet_flops_match_torch_counter():
    from perfbench.reference.styleunet import AvatarNet

    for backward in (False, True):
        with torch.device("meta"):
            net = AvatarNet(512, 3)
            res = 512
            args = (torch.ones(1, res, res), torch.ones(3, res, res), torch.eye(4),
                    torch.ones(res * res, 3), torch.arange(res * res) // res)
        fc = FlopCounterMode(display=False)
        with fc, torch.enable_grad():
            out = net(*args)
            if backward:
                out.sum().backward()
        assert styleunet.flops(512, 3, backward) == fc.get_total_flops()


def test_styleunet_flops_published():
    """AvatarNet(512, 3): 283,075,833,984 FLOPs forward and 836,745,846,912
    forward and backward by torch's counter on real CPU tensors, where the
    camera-space normal's einsum (4×4 by 4×512², 8,388,608 FLOPs) is not
    dispatched as a matrix product; on shapes it is."""
    einsum = 2 * 4 * 4 * 512 * 512
    assert styleunet.flops(512, 3, False) == 283_075_833_984 + einsum
    assert styleunet.flops(512, 3, True) == 836_745_846_912 + einsum


def test_composite_counts_by_hand():
    """One round splat of opacity 0.5 at pixel (8, 8) of a 16×32 frame: the
    terms are the pixels where 0.5·exp(−r²/(2σ²)) ≥ 1/255."""
    sigma2 = 4.0
    p = R.Projected(means2d=torch.tensor([[8.0, 8.0]]),
                    conic=torch.tensor([[1 / sigma2, 0.0, 1 / sigma2]]),
                    depth=torch.tensor([1.0]), radii=torch.tensor([6.0]),
                    rgb=torch.tensor([[1.0, 0.0, 0.0]]), opacity=torch.tensor([0.5]))
    pairs = R.tile_pairs(p, 16, 32)
    c = R.count_terms(p, pairs, 16, 32)
    ys, xs = torch.meshgrid(torch.arange(32.0), torch.arange(16.0), indexing="ij")
    a = 0.5 * torch.exp(-((xs - 8) ** 2 + (ys - 8) ** 2) / (2 * sigma2))
    assert c == {"terms": int((a >= 1 / 255).sum()), "pairs": 1, "splats": 1, "pixels": 512,
                 "tiles": 1}
    f = composite.forward(c, for_backward=True)
    assert f["bytes"] == 40 + 4 + 2 * 4 + 512 * 28
    assert composite.backward(c)["bytes"] == 80 + 4 + 2 * 4 + 512 * 28
    assert f["least_s"] == f["bytes"] / composite.HBM_BYTES_S
    assert composite.flops(c, backward=True) == c["terms"] * 69


def test_saturation_stops_the_count():
    """Ten splats of opacity 0.95 over one tile: after the transmittance falls
    under 1e-4 no further term counts."""
    n = 10
    p = R.Projected(means2d=torch.full((n, 2), 8.0), conic=torch.tensor([[1e-6, 0.0, 1e-6]] * n),
                    depth=torch.arange(1.0, n + 1), radii=torch.full((n,), 3.0),
                    rgb=torch.ones(n, 3), opacity=torch.full((n,), 0.95))
    c = R.count_terms(p, R.tile_pairs(p, 16, 32), 16, 32)
    # the transmittance before the k-th splat is 0.05^(k-1): 1.25e-4 before
    # the fourth, 6.25e-6 before the fifth: four terms a pixel
    assert c["terms"] == 512 * 4


def test_ssim_flops():
    assert ssim.flops(940, 1280, False) == 940 * 1280 * 720
