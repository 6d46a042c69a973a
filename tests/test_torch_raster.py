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
- the plain compositor on the row-span pairs against the plain rect: the
  image outputs bit for bit, gradients 1e-6 × max (summed in another order);
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
from gaussian_garments_tpu_torch.ops.rasterizer_ref import ALPHA_EPS, ALPHA_MAX, rasterize_reference
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


def _rect_pairs(tp, pairs, side):
    """The plain-rect binning: every tile of each alive splat's clipped rect,
    front to back by (stable) depth rank, on ``pairs``' feature table."""
    tx, ty = pairs.tiles_x, pairs.tiles_y
    x0, y0, x1, y1, alive = (v.numpy() for v in tiles.tile_rects(tp, tiles_x=tx, tiles_y=ty))
    per_tile = [[] for _ in range(tx * ty)]
    for i in np.argsort(tp.depth.numpy(), kind="stable"):
        if alive[i]:
            for cy in range(y0[i], min(y1[i], y0[i] + side)):
                for cx in range(x0[i], min(x1[i], x0[i] + side)):
                    per_tile[cy * tx + cx].append(i)
    ranges = np.cumsum([0] + [len(p) for p in per_tile]).astype(np.int32)
    splat = np.array([i for p in per_tile for i in p], np.int32)
    return pairs._replace(pair_splat=torch.from_numpy(splat), ranges=torch.from_numpy(ranges))


def _gate(feats, tile, tx):
    """(len(feats), 512) power and the forward's gate (power ≤ 0, α ≥ 1/255)
    of each splat row of ``feats`` at each pixel of ``tile``, float32 as in
    ``composite_tiles_plain``; and the pixels' (x, y)."""
    p = torch.arange(tiles.PIX)
    px = ((tile % tx) * tiles.TILE_W + p % tiles.TILE_W).to(torch.float32)[None]
    py = ((tile // tx) * tiles.TILE_H + p // tiles.TILE_W).to(torch.float32)[None]
    col = lambda i: feats[:, i:i + 1]
    dx, dy = col(0) - px, col(1) - py
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    al = torch.clamp(col(5) * torch.exp(power), max=ALPHA_MAX)
    return power, (power <= 0.0) & (al >= ALPHA_EPS), px, py


@pytest.mark.parametrize("side", [3, 6])
def test_bin_pairs_against_brute_force(rng, side):
    """The row-span rule: each tile's range holds, front to back by (stable)
    depth rank, alive splats whose clipped rect covers it; every pair of the
    rect that the spans leave out has α < 1/255 at all 512 pixels of its
    tile, and some are left out. At side 3 the wide splats are clipped."""
    _, tp = _project_both(_scene(rng, wide=4))
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H, max_tiles_side=side)
    rect = _rect_pairs(tp, pairs, side)
    tx, ty = tiles.tile_grid(W, H)
    ranges, splat = pairs.ranges.numpy(), pairs.pair_splat.numpy()
    assert ranges[0] == 0 and ranges[-1] == len(splat)
    dropped = 0
    for t in range(tx * ty):
        kept = splat[ranges[t]:ranges[t + 1]].tolist()
        want = rect.pair_splat[rect.ranges[t]:rect.ranges[t + 1]].tolist()
        assert [i for i in want if i in set(kept)] == kept, t
        left_out = sorted(set(want) - set(kept))
        dropped += len(left_out)
        if left_out:
            _, use, _, _ = _gate(pairs.feats[torch.tensor(left_out)], t, tx)
            assert not bool(use.any()), t
    assert dropped > 0 and (int(pairs.n_clipped) > 0) == (side == 3)


def test_row_spans_leave_the_composite_unchanged(rng):
    """The plain compositor on the culled pairs against the plain rect, on
    wide, long thin and near-opaque splats: colour, depth, alpha and final
    log T bit for bit, the last pair names the same splat, and the feature
    gradients agree to 1e-6 × max per component (``index_add_`` sums each
    splat's per-tile terms in another order)."""
    means, scales, rots, opac, shs = _scene(rng, wide=6)
    scales[6:40, 0] *= 8.0
    opac[40:80] = 0.99
    _, tp = _project_both((means, scales, rots, opac, shs))
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H)
    rect = _rect_pairs(tp, pairs, 6)
    assert int(pairs.ranges[-1]) < int(rect.ranges[-1])
    kw = dict(image_height=H, image_width=W)
    cut, full = tiles.composite_tiles_plain(pairs, **kw), tiles.composite_tiles_plain(rect, **kw)
    for name in ("color", "depth", "alpha", "final_logt"):
        assert torch.equal(getattr(cut, name), getattr(full, name)), name
    lc, lf = cut.last_pair.long(), full.last_pair.long()
    assert torch.equal(lc < 0, lf < 0) and bool((lc >= 0).any())
    assert torch.equal(pairs.pair_splat[lc[lc >= 0]], rect.pair_splat[lf[lf >= 0]])
    g = torch.from_numpy(rng.randn(5, H, W).astype(np.float32))
    cot = (g[:3], g[3:4], g[4:5])
    d_cut = tiles.composite_tiles_backward_plain(pairs, cut.final_logt, cut.last_pair, *cot, **kw)
    d_full = tiles.composite_tiles_backward_plain(rect, full.final_logt, full.last_pair, *cot,
                                                  **kw)
    scale = d_full[:, :10].abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert bool(((d_cut - d_full)[:, :10].abs().amax(dim=0) <= 1e-6 * scale).all())
    assert torch.equal(d_cut[:, 10:], torch.zeros_like(d_cut[:, 10:]))


@pytest.mark.parametrize("scene", ["cull", "projected"])
def test_warp_boxes_hold_every_term(rng, scene):
    """The kernels' per-warp cull is safe: every (pixel, pair) term that
    passes the forward's gate lies in the splat's warp box (``warp_extents``,
    the torch twin of the box the kernels compute as they stage a splat,
    compared as the kernels compare it), unless the conic is bad (box -1:
    every warp). Both scenes hold opacity-0.99 (or ≥ 0.95) splats
    with terms past 3σ; the first also long thin splats on warp corners and
    bad conics."""
    if scene == "cull":
        w, h = 96, 64
        proj = tsyn.make_cull_scene(400, 3, width=w, height=h, device="cpu")
    else:
        w, h = W, H
        means, scales, rots, opac, shs = _scene(rng, n=200, wide=4)
        scales[20:60, 1] *= 6.0
        opac[::3] = 0.99
        _, proj = _project_both((means, scales, rots, opac, shs))
    pairs = tiles.bin_pairs(proj, image_width=w, image_height=h)
    f = pairs.feats
    assert torch.equal(f[:, 10:], torch.zeros_like(f[:, 10:]))
    boxes = tiles.warp_extents(tiles.ellipse(proj))
    bad = boxes[:, 0] < 0
    assert torch.equal(bad, boxes[:, 1] < 0) and bool((boxes[~bad] > 0).all())
    if scene == "cull":
        assert int(bad.sum()) == 8
    terms = past_3_sigma = outside_box = 0
    for t in range(pairs.tiles_x * pairs.tiles_y):
        ids = pairs.pair_splat[pairs.ranges[t]:pairs.ranges[t + 1]].long()
        rows = f[ids]
        power, use, px, py = _gate(rows, t, pairs.tiles_x)
        ex, ey = boxes[ids, 0:1], boxes[ids, 1:2]
        inside = ((rows[:, 0:1] - ex <= px) & (rows[:, 0:1] + ex >= px)
                  & (rows[:, 1:2] - ey <= py) & (rows[:, 1:2] + ey >= py))
        assert not bool((use & ~inside & (ex >= 0)).any()), t
        terms += int(use.sum())
        past_3_sigma += int((use & (power < -4.5)).sum())
        outside_box += int((~inside & (ex >= 0)).sum())
    assert terms > 0 and past_3_sigma > 0 and outside_box > terms


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
