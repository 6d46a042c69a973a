"""The plain reference against the program's own plain versions, on the
CPU at small sizes: the texel bind map, the splat render and the cloth
energies. (The reference itself imports nothing of the program; this test
does, to hold one against the other.)"""
import numpy as np
import torch

from perfbench.gen import scene
from perfbench.reference import cloth as C
from perfbench.reference import render as R
from perfbench.reference import texels as T


def test_bind_map_matches_program():
    from gaussian_garments_tpu_torch.models.avatar_gaussian import rasterize_uv_bind_map

    faces = scene.grid_faces(9, 7)
    rng = np.random.default_rng(0)
    for uvs in (scene.garment_uvs(9, 7),
                np.clip(scene.garment_uvs(9, 7) + rng.normal(0, 0.01, (63, 2)), 0, 1)):
        assert np.array_equal(T.uv_bind_map(uvs, faces, 64), rasterize_uv_bind_map(uvs, faces, 64))


def test_render_matches_program_tiles():
    """Against the program's tiled compositor on the CPU (its plain torch
    version), whose tile rects clamp a splat at its 3σ radius and clip it to
    a 6×6-tile window, as the reference does."""
    from gaussian_garments_tpu_torch.ops.projection import ProjectedGaussians
    from gaussian_garments_tpu_torch.ops.tiles import rasterize_tiles

    g = torch.Generator().manual_seed(3)
    n, w, h = 300, 80, 96
    p = R.Projected(means2d=torch.rand(n, 2, generator=g) * torch.tensor([w, h]),
                    conic=torch.stack([torch.rand(n, generator=g) * 0.5 + 0.05,
                                       torch.rand(n, generator=g) * 0.02,
                                       torch.rand(n, generator=g) * 0.5 + 0.05], 1),
                    depth=torch.rand(n, generator=g) + 1, radii=torch.full((n,), 8.0).index_fill(0, torch.arange(0, n, 7), 70.0),
                    rgb=torch.rand(n, 3, generator=g), opacity=torch.rand(n, generator=g))
    rgb, alpha = R.composite(p, R.tile_pairs(p, w, h), w, h)
    q = ProjectedGaussians(p.means2d, p.conic, p.depth, p.radii.int(), p.rgb, p.opacity)
    img, _, a, _ = rasterize_tiles(q, image_height=h, image_width=w, bg=torch.zeros(3))
    assert torch.allclose(rgb, img, atol=1e-5) and torch.allclose(alpha, a, atol=1e-5)


def test_cloth_energies_match_program():
    from types import SimpleNamespace

    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.scene import bind_collision_faces

    g = {"nx": 8, "ny": 8, "radius_x": 0.24, "radius_y": 0.18, "height": 0.75, "z0": 0.0,
         "ripple": 0.08, "sway": 0.02, "turn_deg": 10.0}
    m = scene.garment_motion(g, np.random.default_rng(1))
    f = scene.grid_faces(8, 8)
    vt = torch.as_tensor(scene.garment_pose(g, None, 0.0))
    prev, cur = torch.as_tensor(scene.garment_pose(g, m, 1.0)), torch.as_tensor(
        scene.garment_pose(g, m, 2.0))
    bv, bf = scene.body({"rings": 10, "segments": 12, "axes": [0.2, 0.175, 0.9],
                         "center": [0.0, 0.0, 0.3]})
    mesh = MM.create(vt.numpy(), f, device="cpu")
    mesh = MM.momentum_update(mesh, prev).replace(v=cur)
    mesh = MM.init_body(mesh, bv, bf, bind_collision_faces(cur.numpy(), bv, bf))
    opt = SimpleNamespace(lambda_bending=0.03, lambda_stretching=0.01, lambda_collision=1e3,
                          lambda_virtual=0.05)
    cl = C.build(vt, torch.as_tensor(f), prev, cur, torch.as_tensor(bv), torch.as_tensor(bf))
    for body in (False, True):
        want = sum(MM.get_energy_loss(mesh, opt, body).values())
        got = C.energies(cl, cur, vars(opt), body)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-9), (body, got, want)
