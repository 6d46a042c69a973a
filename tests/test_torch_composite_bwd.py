"""The port's backward splat compositor (``composite_tiles_backward_plain``,
through the port's autograd Function and projection) against the gradients
of the JAX Pallas kernel, run in interpret mode as ``tests/test_pallas.py``
runs it, on that file's scenes: 120 splats, and one saturated tile of 600
near-opaque splats. Gradients are taken of the same loss with respect to
means, opacity, scales, rotations, SH and the background colour.

Tolerance: 1e-4 × max|JAX gradient| per input (2e-4 on the saturated tile),
the bounds ``tests/test_pallas.py`` holds the Pallas backward to against the
exact oracle. The two sum in different orders (the TPU kernel with
triangular matmuls over 128-pair blocks and a segment sum, the port serially
per pixel and with ``index_add_``), so they agree to float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.ops.pallas_tiles import rasterize_pallas, rasterize_pallas_batch
from gaussian_garments_tpu.ops.projection import project_gaussians as j_project
from gaussian_garments_tpu.utils.camera import make_camera as j_make_camera
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
from gaussian_garments_tpu_torch.utils.camera import make_camera

H = W = 64
NAMES = ("means", "opac", "scales", "rots", "shs", "bg")
CAM_T = (np.array([0.0, 0, 3.0]), np.array([0.2, -0.1, 3.2]))


def _scene(rng, n=120):
    means = rng.randn(n, 3).astype(np.float32) * 0.3
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.4 - 3.2)
    rots = rng.randn(n, 4).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.randn(n, 1)))).astype(np.float32).reshape(-1)
    shs = rng.randn(n, 1, 3).astype(np.float32) * 0.3
    return means, opac, scales, rots, shs


def _saturated(rng, n=600):
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.randn(n).astype(np.float32) * 0.015
    means[:, 1] = rng.randn(n).astype(np.float32) * 0.015
    means[:, 2] = np.linspace(-0.4, 0.4, n).astype(np.float32)
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.2 - 3.4)
    rots = rng.randn(n, 4).astype(np.float32)
    opac = np.full((n,), 0.97, np.float32)
    shs = rng.randn(n, 1, 3).astype(np.float32) * 0.3
    return means, opac, scales, rots, shs


def _cam_kw(k, h=H, w=W):
    return dict(R=np.eye(3), T=CAM_T[k], fx=150, fy=150, cx=w / 2, cy=h / 2, width=w, height=h)


def _loss(img, d, a, target):
    return ((img - target) ** 2).mean() + 0.1 * d.mean() + 0.05 * (a ** 2).mean()


def _jax_grads(arrays, target, bg, n_cams=1):
    cams = [j_make_camera(**_cam_kw(k)) for k in range(n_cams)]

    def loss(m, o, s, r, sh, b):
        projs = [j_project(m, c.world_view_transform, c.full_proj_transform, c.camera_center,
                           image_width=W, image_height=H, tanfovx=c.tanfovx,
                           tanfovy=c.tanfovy, scales=s, rotations=r, shs=sh, opacities=o,
                           sh_degree=0) for c in cams]
        if n_cams == 1:
            img, d, a, _ = rasterize_pallas(projs[0], image_height=H, image_width=W, bg=b,
                                            interpret=True, pair_budget=8192)
        else:
            stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *projs)
            img, d, a, _ = rasterize_pallas_batch(stacked, image_height=H, image_width=W,
                                                  bg=b, interpret=True, pair_budget=16384)
        return _loss(img, d, a, jnp.asarray(target))

    args = tuple(jnp.asarray(x) for x in arrays) + (jnp.asarray(bg),)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(*args)]


def _torch_grads(arrays, target, bg, n_cams=1, raster=None):
    leaves = [torch.tensor(x, requires_grad=True) for x in tuple(arrays) + (bg,)]
    m, o, s, r, sh, b = leaves
    h, w = target.shape[-2:]
    imgs, ds, alphas = [], [], []
    for k in range(n_cams):
        c = make_camera(**_cam_kw(k, h, w), device="cpu")
        proj = project_gaussians(m, c.world_view_transform, c.full_proj_transform,
                                 c.camera_center, image_width=w, image_height=h,
                                 tanfovx=c.tanfovx, tanfovy=c.tanfovy, scales=s, rotations=r,
                                 shs=sh, opacities=o, sh_degree=0)
        if raster is None:
            img, d, a, _ = tiles.rasterize_tiles(proj, image_height=h, image_width=w, bg=b)
        else:
            img, d, a = raster(proj, b)
        imgs.append(img), ds.append(d), alphas.append(a)
    stack = lambda xs: torch.stack(xs) if n_cams > 1 else xs[0]
    _loss(stack(imgs), stack(ds), stack(alphas), torch.from_numpy(target)).backward()
    return [x.grad.numpy() for x in leaves]


def _assert_close(got, want, rel):
    for name, a, b in zip(NAMES, got, want):
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a, b, rtol=0, atol=scale * rel, err_msg=name)


def test_backward_matches_pallas(rng):
    arrays = _scene(rng)
    target = rng.rand(3, H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    _assert_close(_torch_grads(arrays, target, bg), _jax_grads(arrays, target, bg), 1e-4)


def test_backward_matches_pallas_on_saturated_tile(rng):
    """> 256 near-opaque pairs on one tile and a composite that saturates in
    front: the walk starts at each pixel's last contributing pair."""
    arrays = _saturated(rng)
    target = rng.rand(3, H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    c = make_camera(**_cam_kw(0), device="cpu")
    proj = project_gaussians(*(torch.from_numpy(x) for x in (arrays[0],)), c.world_view_transform,
                             c.full_proj_transform, c.camera_center, image_width=W,
                             image_height=H, tanfovx=c.tanfovx, tanfovy=c.tanfovy,
                             scales=torch.from_numpy(arrays[2]),
                             rotations=torch.from_numpy(arrays[3]),
                             shs=torch.from_numpy(arrays[4]),
                             opacities=torch.from_numpy(arrays[1]), sh_degree=0)
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    out = tiles.composite_tiles(pairs, image_height=H, image_width=W)
    counts = pairs.ranges[1:] - pairs.ranges[:-1]
    assert int(counts.max()) > 256 and float(out.alpha.max()) > 0.9999
    assert int((out.last_pair.long() - pairs.ranges[0]).max()) < int(pairs.ranges[-1]) - 1
    _assert_close(_torch_grads(arrays, target, bg), _jax_grads(arrays, target, bg), 2e-4)


def test_backward_matches_pallas_batch_two_cameras(rng):
    arrays = _scene(rng, n=80)
    target = rng.rand(2, 3, H, W).astype(np.float32)
    bg = np.array([0.3, 0.1, 0.2], np.float32)
    _assert_close(_torch_grads(arrays, target, bg, n_cams=2),
                  _jax_grads(arrays, target, bg, n_cams=2), 1e-4)


@pytest.mark.parametrize("size", [(64, 64), (40, 50)])
def test_backward_matches_autograd_of_oracle(rng, size):
    """Against torch autograd through the port's exact per-pixel oracle, at
    opacity ≤ 0.35 where the tiled path drops nothing (see
    ``make_splat_scene``); the oracle sums log T by cumsum, so 1e-4 × max. At
    40×50 the edge tiles hold pixels outside the image, which add nothing."""
    h, w = size
    means, opac, scales, rots, shs = _scene(rng, n=100)
    arrays = (means, opac * 0.35, scales, rots, shs)
    target = rng.rand(3, h, w).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    oracle = lambda proj, b: rasterize_reference(proj, image_height=h, image_width=w, bg=b)
    _assert_close(_torch_grads(arrays, target, bg),
                  _torch_grads(arrays, target, bg, raster=oracle), 1e-4)


def test_culled_and_offscreen_splats_get_zero_gradient(rng):
    """A splat behind the camera and one far off screen never reach a tile:
    their feature gradients are exactly zero, not NaN."""
    means, opac, scales, rots, shs = _scene(rng, n=40)
    means[0] = [0.0, 0.0, -5.0]          # behind the camera (z_view < 0.2)
    means[1] = [40.0, 0.0, 0.0]          # far off screen
    c = make_camera(**_cam_kw(0), device="cpu")
    T = torch.from_numpy
    proj = project_gaussians(T(means), c.world_view_transform, c.full_proj_transform,
                             c.camera_center, image_width=W, image_height=H,
                             tanfovx=c.tanfovx, tanfovy=c.tanfovy, scales=T(scales),
                             rotations=T(rots), shs=T(shs), opacities=T(opac), sh_degree=0)
    assert int(proj.radii[0]) == 0 and int(proj.radii[1]) == 0
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    out = tiles.composite_tiles_plain(pairs, image_height=H, image_width=W)
    g = torch.from_numpy(rng.randn(5, H, W).astype(np.float32))
    d = tiles.composite_tiles_backward_plain(
        pairs, out.final_logt, out.last_pair, g[:3], g[3:4], g[4:5], image_height=H,
        image_width=W)
    assert torch.isfinite(d).all()
    assert torch.equal(d[:2], torch.zeros_like(d[:2]))
    assert float(d[2:, :10].abs().sum()) > 0 and torch.equal(d[:, 10:], torch.zeros_like(d[:, 10:]))


def test_cuda_backward_refuses_cpu_tensors(rng):
    means, opac, scales, rots, shs = _scene(rng, n=20)
    c = make_camera(**_cam_kw(0), device="cpu")
    T = torch.from_numpy
    proj = project_gaussians(T(means), c.world_view_transform, c.full_proj_transform,
                             c.camera_center, image_width=W, image_height=H,
                             tanfovx=c.tanfovx, tanfovy=c.tanfovy, scales=T(scales),
                             rotations=T(rots), shs=T(shs), opacities=T(opac), sh_degree=0)
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    out = tiles.composite_tiles_plain(pairs, image_height=H, image_width=W)
    z = torch.zeros((1, H, W))
    with pytest.raises(ValueError, match="cuda"):
        tiles.composite_tiles_backward_cuda(pairs, out.final_logt, out.last_pair,
                                            torch.zeros((3, H, W)), z, z, image_height=H,
                                            image_width=W)
