"""The CUDA splat compositor on the card, forward and backward, held against
its plain PyTorch versions and the exact oracle. Every test here needs an
NVIDIA GPU with nvcc and skips without one; run them on the card with

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

The backward kernel sums with atomics in an order that changes from run to
run: it is held to its plain version at 1e-4 × max|plain| per gradient
component (2e-4 on a saturated tile), the bounds ``tests/test_pallas.py``
holds the TPU kernel to.
"""
import numpy as np
import pytest
import torch

from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene, make_splat_scene
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
from gaussian_garments_tpu_torch.utils.camera import make_camera

pytestmark = pytest.mark.cuda

H = W = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from gaussian_garments_tpu_torch import pin_full_f32
    pin_full_f32()
    return torch.device("cuda", 0)


def _proj(dev, n, n_wide=0, seed=0, max_opacity=1.0):
    s = make_splat_scene(n, seed, n_wide=n_wide, max_opacity=max_opacity)
    cam = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=300, fy=300,
                      cx=W / 2, cy=H / 2, width=W, height=H, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in s.items()}
    return project_gaussians(
        t["means"], cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=W, image_height=H, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t["scales"], rotations=t["rots"], shs=t["shs"], opacities=t["opacity"],
        sh_degree=0)


def _both(proj):
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    k = tiles.composite_tiles(pairs, image_height=H, image_width=W)
    p = tiles.composite_tiles_plain(pairs, image_height=H, image_width=W)
    torch.cuda.synchronize()
    return pairs, k, p


@pytest.mark.parametrize("n_wide", [0, 8])
def test_kernel_matches_plain(dev, n_wide):
    """Same gates, same serial order, -fmad=false: agreement to 1e-4 (image,
    alpha), 1e-3 × depth range (depth), and the same last pair."""
    proj = _proj(dev, 20000, n_wide=n_wide)
    pairs, k, p = _both(proj)
    if n_wide:
        assert int(pairs.n_clipped) > 0
    torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(k.alpha, p.alpha, atol=1e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3 * drange, rtol=0)
    assert (k.last_pair == p.last_pair).float().mean() > 0.999


def test_kernel_matches_oracle(dev):
    """No clipping, and opacities ≤ 0.35 so that no splat reaches α ≥ 1/255
    outside its 3σ tile rect (see ``make_splat_scene``): the kernel equals the
    per-pixel oracle. The oracle sums log T in another order, so the T ≥ 1e-4
    gate can flip on a pixel, which moves its alpha by at most 1e-4:
    tolerance 2e-4."""
    proj = _proj(dev, 20000, max_opacity=0.35)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    img, depth, alpha, aux = tiles.rasterize_tiles(proj, image_height=H, image_width=W, bg=bg)
    assert int(aux["n_clipped"]) == 0
    ir, dr, ar = rasterize_reference(proj, image_height=H, image_width=W, bg=bg,
                                     pixel_chunk=4096)
    torch.testing.assert_close(img, ir, atol=2e-4, rtol=0)
    torch.testing.assert_close(alpha, ar, atol=2e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(depth, dr, atol=1e-3 * drange, rtol=0)


def test_launch_counter_and_no_backward(dev):
    """One forward launch per composite, and the backward goes through the
    backward kernel (it once raised; now it launches exactly once)."""
    proj = _proj(dev, 2000)
    before = tiles.composite_tiles_cuda.launches
    before_bwd = tiles.composite_tiles_backward_cuda.launches
    feats = tiles.bin_pairs(proj, image_width=W, image_height=H)
    feats = feats._replace(feats=feats.feats.clone().requires_grad_(True))
    out = tiles.composite_tiles(feats, image_height=H, image_width=W)
    assert tiles.composite_tiles_cuda.launches == before + 1
    out.color.sum().backward()
    assert tiles.composite_tiles_backward_cuda.launches == before_bwd + 1
    assert torch.isfinite(feats.feats.grad).all()


def test_kernel_rejects_wrong_dtype(dev):
    pairs = tiles.bin_pairs(_proj(dev, 100), image_width=W, image_height=H)
    with pytest.raises(ValueError):
        tiles.composite_tiles_cuda(pairs._replace(ranges=pairs.ranges.long()),
                                   image_height=H, image_width=W)


def _cotangents(dev, seed=0):
    g = np.random.RandomState(seed).randn(5, H, W).astype(np.float32)
    g = torch.as_tensor(g, device=dev)
    return g[:3].contiguous(), g[3:4].contiguous(), g[4:5].contiguous()


def backward_error(pairs, out, cot):
    """Per-component max |kernel − plain| over max |plain| (columns 0-9)."""
    kw = dict(image_height=H, image_width=W)
    k = tiles.composite_tiles_backward_cuda(pairs, out.final_logt, out.last_pair, *cot, **kw)
    p = tiles.composite_tiles_backward_plain(pairs, out.final_logt, out.last_pair, *cot, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert torch.equal(k[:, 10:], torch.zeros_like(k[:, 10:]))
    scale = p[:, :10].abs().amax(dim=0).clamp(min=1e-30)
    return float(((k - p)[:, :10].abs().amax(dim=0) / scale).max())


@pytest.mark.parametrize("n_wide,max_opacity", [(0, 0.35), (0, 1.0), (8, 1.0)])
def test_backward_kernel_matches_plain(dev, n_wide, max_opacity):
    proj = _proj(dev, 20000, n_wide=n_wide, max_opacity=max_opacity)
    pairs, out, _ = _both(proj)
    assert backward_error(pairs, out, _cotangents(dev)) <= 1e-4


def test_backward_kernel_matches_plain_on_saturated_tile(dev):
    n = 600
    rng = np.random.RandomState(1)
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.randn(n, 2).astype(np.float32) * 0.015
    means[:, 2] = np.linspace(-0.4, 0.4, n)
    t = lambda x: torch.as_tensor(x, device=dev)
    cam = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=300, fy=300,
                      cx=W / 2, cy=H / 2, width=W, height=H, device=dev)
    proj = project_gaussians(
        t(means), cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=W, image_height=H, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t(np.exp(rng.randn(n, 3).astype(np.float32) * 0.2 - 3.4)),
        rotations=t(rng.randn(n, 4).astype(np.float32)),
        shs=t(rng.randn(n, 1, 3).astype(np.float32) * 0.3),
        opacities=t(np.full((n,), 0.97, np.float32)), sh_degree=0)
    pairs, out, _ = _both(proj)
    assert int((pairs.ranges[1:] - pairs.ranges[:-1]).max()) > 256
    assert float(out.alpha.max()) > 0.9999
    assert backward_error(pairs, out, _cotangents(dev, 1)) <= 2e-4


def test_kernels_match_plain_on_cull_scene(dev):
    """Splats aimed at the culls (``make_cull_scene``): opacity 0.95-0.99
    contours past 3σ, centres on warp corners, long thin and bad-conic
    splats. The forward matches its plain version as above; the backward to
    1e-4 × max per component."""
    proj = make_cull_scene(3000, 4, width=W, height=H, device=dev)
    pairs, k, p = _both(proj)
    assert bool((tiles.warp_extents(tiles.ellipse(proj))[:, 0] < 0).any())
    torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(k.alpha, p.alpha, atol=1e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3 * drange, rtol=0)
    assert (k.last_pair == p.last_pair).float().mean() > 0.999
    assert backward_error(pairs, k, _cotangents(dev, 3)) <= 1e-4


def test_backward_kernel_matches_oracle_autograd(dev):
    """Opacity ≤ 0.35: the kernel's gradients of the splat features equal
    torch autograd through the exact per-pixel oracle to 1e-4 × max."""
    proj = _proj(dev, 3000, max_opacity=0.35)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    target = torch.as_tensor(np.random.RandomState(2).rand(3, H, W).astype(np.float32),
                             device=dev)
    grads = []
    for raster in ("kernel", "oracle"):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (proj.means2d, proj.conic, proj.rgb, proj.opacity, proj.depth)]
        p = proj._replace(means2d=leaves[0], conic=leaves[1], rgb=leaves[2],
                          opacity=leaves[3], depth=leaves[4])
        if raster == "kernel":
            img, depth, alpha, _ = tiles.rasterize_tiles(p, image_height=H, image_width=W, bg=bg)
        else:
            img, depth, alpha = rasterize_reference(p, image_height=H, image_width=W, bg=bg,
                                                    pixel_chunk=4096)
        loss = ((img - target) ** 2).mean() + 0.1 * depth.mean() + 0.05 * (alpha ** 2).mean()
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


# ---------------------------------------------------------------------------
# the probe kernels (``csrc/probe_gather.cu``, ``csrc/probe_composite.cu``),
# each against its plain version with the tolerance its entry states
# ---------------------------------------------------------------------------

def _held(entry):
    from gaussian_garments_tpu_torch.probes.common import check

    before = entry.wrapper.launches
    err, ok = check(entry)
    assert ok, (entry.name, entry.row, err, entry.tolerance)
    assert entry.wrapper.launches == before + 1


@pytest.mark.parametrize("row", ["3", "4C", "5", "4A", "4B"])
def test_gather_probe_kernels_match_plain(dev, row):
    from gaussian_garments_tpu_torch.probes import gather

    for e in gather.entries(dev, rows=(row,)):
        _held(e)


def test_composite_probe_kernels_match_plain(dev):
    from gaussian_garments_tpu_torch.probes import composite_null, grid_overhead
    from gaussian_garments_tpu_torch.probes.worklist import build_worklist

    pairs = tiles.bin_pairs(_proj(dev, 20000), image_width=W, image_height=H)
    for e in composite_null.entries(pairs, H, W):
        _held(e)
    for e in grid_overhead.entries(pairs, build_worklist(pairs.ranges)):
        _held(e)
