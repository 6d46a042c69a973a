"""PyTorch port against the JAX package: tile binning, the splat compositor's
plain version, the exact oracle, and the mesh rasterizer, on the CPU.

The JAX kernel runs in Pallas interpret mode, as ``tests/test_pallas.py``
runs it, at that file's sizes (64², ~150 splats). Tolerances:

- plain compositor against the kernel and the oracle: image and alpha
  atol 2e-5, depth 2e-4, the bounds ``tests/test_pallas.py`` holds the JAX
  kernel to. The three sum log T in different orders (the kernel in 128-wide
  prefix blocks, the oracle by cumsum, the plain version serially), so they
  agree to float32 rounding and not bit for bit;
- tile rects, pair counts, clip counts and mesh face ids: exact;
- mesh depth: atol 1e-5 (the same float32 expressions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.ops import pallas_tiles as JPT
from gaussian_garments_tpu.ops.mesh_raster import rasterize_mesh as j_rasterize_mesh
from gaussian_garments_tpu.ops.projection import project_gaussians as j_project
from gaussian_garments_tpu.ops.rasterizer_ref import rasterize_reference as j_reference
from gaussian_garments_tpu.ops.tiled import bin_splats as j_bin_splats
from gaussian_garments_tpu.utils.camera import make_camera as j_make_camera
from gaussian_garments_tpu_torch.data import synthetic as tsyn
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
from gaussian_garments_tpu_torch.ops.tiled import bin_splats
from gaussian_garments_tpu_torch.utils.camera import make_camera

H = W = 64
BG = [0.1, 0.2, 0.3]
IMG_ATOL, DEPTH_ATOL = 2e-5, 2e-4


def _scene(rng, n=150, wide=0, low_opacity=False):
    means = rng.randn(n, 3).astype(np.float32) * 0.3
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.4 - 3.2)
    rots = rng.randn(n, 4).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.randn(n)))).astype(np.float32)
    shs = rng.randn(n, 1, 3).astype(np.float32) * 0.3
    if wide:
        scales[:wide] = np.exp(rng.randn(wide, 3).astype(np.float32) * 0.1 - 1.9)
    if low_opacity:
        opac[::3] = 0.01
        opac[1::3] = 0.002
    return means, scales, rots, opac, shs


def _project_both(arrays, width=W, height=H):
    means, scales, rots, opac, shs = arrays
    kw = dict(R=np.eye(3), T=np.array([0.0, 0, 3.0]), fx=150, fy=150, cx=width / 2,
              cy=height / 2, width=width, height=height)
    jc, tc = j_make_camera(**kw), make_camera(**kw, device="cpu")
    common = dict(image_width=width, image_height=height, tanfovx=jc.tanfovx,
                  tanfovy=jc.tanfovy, sh_degree=0)
    jp = j_project(jnp.asarray(means), jc.world_view_transform, jc.full_proj_transform,
                   jc.camera_center, scales=jnp.asarray(scales), rotations=jnp.asarray(rots),
                   shs=jnp.asarray(shs), opacities=jnp.asarray(opac), **common)
    T = torch.from_numpy
    tp = project_gaussians(T(means), tc.world_view_transform, tc.full_proj_transform,
                           tc.camera_center, scales=T(scales), rotations=T(rots), shs=T(shs),
                           opacities=T(opac), **common)
    return jp, tp


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("wide", [0, 6])
def test_tile_rects_and_clip_count_match_jax(rng, wide):
    """The opacity-aware rects and the alive rule are those of
    ``_tile_rects``; the clip count is that of ``pack_pairs``."""
    jp, tp = _project_both(_scene(rng, wide=wide))
    tx, ty = tiles.tile_grid(W, H)
    assert (tx, ty) == (-(-W // JPT.TILE_W), -(-H // JPT.TILE_H))
    for a, b in zip(tiles.tile_rects(tp, tiles_x=tx, tiles_y=ty),
                    JPT._tile_rects(jp, tiles_x=tx, tiles_y=ty)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pp = JPT.pack_pairs(jp, tiles_x=tx, tiles_y=ty, max_tiles_side=2, pair_budget=8192)
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H, max_tiles_side=2)
    assert int(pairs.n_clipped) == int(pp.n_clipped)
    assert int(pairs.n_clipped) > 0


def test_bin_pairs_against_brute_force(rng):
    """Each tile's range holds exactly the alive splats whose clipped rect
    covers it, front to back by (stable) depth rank."""
    _, tp = _project_both(_scene(rng, wide=4))
    side = 3
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H, max_tiles_side=side)
    tx, ty = tiles.tile_grid(W, H)
    x0, y0, x1, y1, alive = (v.numpy() for v in tiles.tile_rects(tp, tiles_x=tx, tiles_y=ty))
    rank = np.empty(len(alive), np.int64)
    rank[np.argsort(tp.depth.numpy(), kind="stable")] = np.arange(len(alive))
    ranges = pairs.ranges.numpy()
    splat = pairs.pair_splat.numpy()
    assert ranges[0] == 0 and ranges[-1] == len(splat)
    for t in range(tx * ty):
        cx, cy = t % tx, t // tx
        want = [i for i in range(len(alive)) if alive[i]
                and x0[i] <= cx < min(x1[i], x0[i] + side)
                and y0[i] <= cy < min(y1[i], y0[i] + side)]
        want.sort(key=lambda i: rank[i])
        assert splat[ranges[t]:ranges[t + 1]].tolist() == want, t


@pytest.mark.parametrize("case", ["plain", "low_opacity"])
def test_plain_compositor_matches_oracles(rng, case):
    """No splat is clipped: the plain compositor equals both the port's and
    the JAX package's per-pixel oracle."""
    jp, tp = _project_both(_scene(rng, low_opacity=case == "low_opacity"))
    bg = torch.tensor(BG)
    img, depth, alpha, aux = tiles.rasterize_tiles(tp, image_height=H, image_width=W, bg=bg)
    assert int(aux["n_clipped"]) == 0 and int(aux["n_overflow"]) == 0
    ir, dr, ar = j_reference(jp, image_height=H, image_width=W, bg=jnp.asarray(BG))
    _close(img, ir, IMG_ATOL)
    _close(alpha, ar, IMG_ATOL)
    _close(depth, dr, DEPTH_ATOL)
    tr, tdr, tar = rasterize_reference(tp, image_height=H, image_width=W, bg=bg, pixel_chunk=1000)
    _close(tr, ir, IMG_ATOL)
    _close(tar, ar, IMG_ATOL)
    _close(tdr, dr, DEPTH_ATOL)


@pytest.mark.parametrize("side", [6, 2])
def test_plain_compositor_matches_pallas_interpret(rng, side):
    """Against the TPU kernel itself (interpret mode). At side 2 many splats
    exceed the clip window, and both keep the same top-left 2×2 tiles."""
    jp, tp = _project_both(_scene(rng, wide=6))
    ip, dp, ap, jaux = JPT.rasterize_pallas(jp, image_height=H, image_width=W,
                                            bg=jnp.asarray(BG), max_tiles_side=side,
                                            pair_budget=8192, interpret=True)
    img, depth, alpha, aux = tiles.rasterize_tiles(tp, image_height=H, image_width=W,
                                                   bg=torch.tensor(BG), max_tiles_side=side)
    assert int(aux["n_clipped"]) == int(jaux["n_clipped"])
    if side == 2:
        assert int(aux["n_clipped"]) > 0
    _close(img, ip, IMG_ATOL)
    _close(alpha, ap, IMG_ATOL)
    _close(depth, dp, DEPTH_ATOL)


def test_plain_compositor_outputs_for_backward(rng):
    """final log T and the last contributing pair agree with a direct serial
    recomputation over each pixel's sorted pairs."""
    _, tp = _project_both(_scene(rng, n=60))
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H)
    out = tiles.composite_tiles(pairs, image_height=H, image_width=W)
    f = pairs.feats.numpy().astype(np.float64)
    tx, _ = tiles.tile_grid(W, H)
    for y, x in [(5, 7), (31, 33), (40, 20), (63, 63)]:
        t = (y // tiles.TILE_H) * tx + x // tiles.TILE_W
        lo, hi = pairs.ranges[t].item(), pairs.ranges[t + 1].item()
        log_t, last = 0.0, -1
        for p in range(lo, hi):
            s = f[pairs.pair_splat[p].item()]
            dx, dy = s[0] - x, s[1] - y
            power = -0.5 * (s[2] * dx * dx + s[4] * dy * dy) - s[3] * dx * dy
            a = min(0.99, s[5] * np.exp(power))
            if np.exp(log_t) < 1e-4:
                break
            if power > 0 or a < 1 / 255:
                continue
            log_t += np.log1p(-a)
            last = p
        assert out.last_pair[y, x].item() == last
        assert out.final_logt[y, x].item() == pytest.approx(log_t, abs=1e-4)


def test_cuda_route_refuses_cpu_tensors(rng):
    """The kernel's wrapper takes CUDA tensors only: there is no path from it
    to the plain version."""
    _, tp = _project_both(_scene(rng, n=20))
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H)
    with pytest.raises(ValueError, match="cuda"):
        tiles.composite_tiles_cuda(pairs, image_height=H, image_width=W)


def _mesh_cameras():
    from gaussian_garments_tpu.data import synthetic as jsyn

    kw = dict(radius=0.4, height=2.2, width=72, height_px=56)
    return jsyn.make_camera_ring(2, **kw), tsyn.make_camera_ring(2, **kw, device="cpu")


@pytest.mark.parametrize("cam", [0, 1])
def test_rasterize_mesh_matches_jax(rng, cam):
    verts, faces, _ = tsyn.make_cloth_template(9, 8)
    verts = verts + rng.randn(*verts.shape).astype(np.float32) * 0.02
    jcs, tcs = _mesh_cameras()
    jc, tc = jcs[cam], tcs[cam]
    jf, jz = j_rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces.astype(np.int32)),
                              jc.world_view_transform, jc.full_proj_transform,
                              image_width=72, image_height=56)
    tf, tz = rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces),
                            tc.world_view_transform, tc.full_proj_transform,
                            image_width=72, image_height=56)
    assert (np.asarray(jf) >= 0).mean() > 0.2
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    hit = np.isfinite(np.asarray(jz))
    np.testing.assert_array_equal(np.isfinite(tz.numpy()), hit)
    np.testing.assert_allclose(tz.numpy()[hit], np.asarray(jz)[hit], rtol=0, atol=1e-5)


def test_bin_splats_matches_jax(rng):
    """First ``tile_capacity`` items by depth rank, ``max_tiles_side`` clip,
    overflow and clip counts: the masked slots are equal."""
    n = 300
    means2d = (rng.rand(n, 2) * [70, 50]).astype(np.float32)
    radii = rng.randint(0, 30, n).astype(np.int32)
    depth = rng.rand(n).astype(np.float32)
    depth[::7] = depth[0]                                    # ties keep their order
    kw = dict(tiles_x=5, tiles_y=4, tile_size=16, max_tiles_side=3, tile_capacity=16)
    jb = j_bin_splats(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depth), **kw)
    tb = bin_splats(torch.from_numpy(means2d), torch.from_numpy(radii),
                    torch.from_numpy(depth), **kw)
    mask = np.asarray(jb.tile_mask)
    np.testing.assert_array_equal(tb.tile_mask.numpy(), mask)
    np.testing.assert_array_equal(tb.tile_idx.numpy()[mask], np.asarray(jb.tile_idx)[mask])
    assert int(tb.n_overflow) == int(jb.n_overflow) > 0
    assert int(tb.n_clipped) == int(jb.n_clipped) > 0
