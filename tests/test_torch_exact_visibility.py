"""Exact visibility (``inference --exact_visibility``) in the port against the
JAX package, on the CPU: the brute-force first-hit ray cast, the joint
visibility of the doll, the per-texel exact and face-granular masks, and the
inference slice with ``--exact_visibility --dense_texels``.

Tolerances: the ray casts run the same float32 Möller–Trumbore formulas, so
on rays whose two nearest hits are distinct (by more than 1e-4 relative) the
prim ids are equal and t agrees to 1e-5 relative. The masks are equal except
at texels whose anchor lies on an edge of its own face (a barycentric
coordinate under 1e-5; on these sheets the u + v = 1 diagonal runs through
texel centres): the camera→anchor ray then meets the edge itself, and whether
it counts for either face is decided by the last bit, which XLA's fused
evaluation and the eager one (JAX's own included) round differently. The
slice's PNG rows differ by at most 1 uint8 level, as in
``tests/test_torch_inference.py``, with those texels made transparent.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu import doll as D
from gaussian_garments_tpu.config import DEFAULTS
from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.ops import raytrace as JRT
from gaussian_garments_tpu_torch import doll as TD
from gaussian_garments_tpu_torch.config import DEFAULTS as TORCH_DEFAULTS
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.ops import raytrace as TRT

T = torch.from_numpy


def _on_edge(bind) -> np.ndarray:
    """Texels whose anchor lies on an edge of its face."""
    return np.abs(bind.gs_bc.numpy()).min(axis=1) < 1e-5


def _two_sheets():
    """A 6×6 sheet and a copy 0.3 nearer a camera above it, shifted aside."""
    verts, faces, uvs = jsyn.make_cloth_template(6, 6)
    cam = jsyn.make_camera_ring(1, radius=0.4, height=2.2, width=64, height_px=64)[0]
    toward = np.asarray(cam.camera_center) / np.linalg.norm(np.asarray(cam.camera_center))
    front = (verts + toward * 0.3 + np.array([0.013, -0.021, 0.0])).astype(np.float32)
    return verts, faces, uvs, front, cam


def test_raycast_matches_raycast_jnp(rng):
    verts, faces, _, front, cam = _two_sheets()
    # the front sheet half aside, so that rays reach the back sheet too
    scene_v = np.concatenate([front + np.array([0.5, 0.0, 0.0]), verts]).astype(np.float32)
    scene_f = np.concatenate([faces, faces + len(verts)])
    centre = np.asarray(cam.camera_center, np.float32)
    # rays from the camera at points of both sheets, and a spread that misses
    targets = np.concatenate([scene_v[scene_f].mean(1) + rng.randn(len(scene_f), 3) * 0.02,
                              rng.randn(200, 3) * 2.0]).astype(np.float32)
    d = targets - centre
    dirs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    origins = np.broadcast_to(centre, dirs.shape).copy()
    jt, jid = (np.asarray(x) for x in JRT.raycast_jnp(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(scene_v),
        jnp.asarray(scene_f.astype(np.int32))))
    tt, tid = TRT.raycast(T(origins), T(dirs), T(scene_v), T(scene_f))
    t7, id7 = TRT.raycast(T(origins), T(dirs), T(scene_v), T(scene_f),
                          budget=7 * 12 * len(scene_f))     # chunks of 7 rays
    assert torch.equal(tid, id7) and torch.equal(tt, t7)
    # rays whose two nearest hits are distinct
    v0 = scene_v[scene_f[:, 0]]
    all_t = np.sort(np.asarray(JRT._moller_trumbore(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(v0),
        jnp.asarray(scene_v[scene_f[:, 1]] - v0), jnp.asarray(scene_v[scene_f[:, 2]] - v0))),
        axis=1)
    hit = np.isfinite(jt)
    distinct = ~hit | (all_t[:, 1] > all_t[:, 0] * (1 + 1e-4))
    assert distinct.mean() > 0.9 and 0.2 < hit.mean() < 0.95 and (jid[hit] >= len(faces)).any()
    np.testing.assert_array_equal(tid.numpy()[distinct], jid[distinct])
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    np.testing.assert_allclose(tt.numpy()[distinct & hit], jt[distinct & hit], rtol=1e-5)
    assert (tid.numpy()[~hit] == -1).all() and np.isinf(tt.numpy()[~hit]).all()
    # the point-visibility test on the sheets' anchor points
    pts, exp = targets[:len(scene_f)], np.arange(len(scene_f))
    want = np.asarray(JRT.visibility_jnp(
        jnp.asarray(pts), jnp.asarray(centre), jnp.asarray(scene_v),
        jnp.asarray(scene_f.astype(np.int32)), jnp.asarray(exp.astype(np.int32))))
    got = TRT.visibility(T(pts), T(centre), T(scene_v), T(scene_f), T(exp)).numpy()
    np.testing.assert_array_equal(got[distinct[:len(scene_f)]], want[distinct[:len(scene_f)]])


def test_joint_visibility_matches_jax():
    """``tests/test_inference.py``'s front and back sheets as two garments."""
    verts, faces, uvs, front, cam = _two_sheets()
    jbind, _ = JAG.build_binding(uvs, faces, 32)
    tbind, _ = TAG.build_binding(uvs, faces, 32, device="cpu")
    jups, tups = [], []
    for v in (front, verts):
        jv, jf = jnp.asarray(v), jnp.asarray(faces.astype(np.int32))
        jups.append({"anchor": JAG.barycentric_3d(jbind, jv, jf), "mesh_v": jv, "mesh_f": jf})
        tups.append({"anchor": TAG.barycentric_3d(tbind, T(v), T(faces)), "mesh_v": T(v),
                     "mesh_f": T(faces)})
    want = np.asarray(D.joint_visibility(jups, cam.camera_center))
    got = TD.joint_visibility(tups, T(np.asarray(cam.camera_center)))
    n = len(want) // 2
    assert want[:n].mean() > 0.8 and want[n:].mean() < 0.4
    inner = ~np.tile(_on_edge(tbind), 2)
    assert inner.mean() > 0.95
    np.testing.assert_array_equal(got.numpy()[inner], want[inner])


def test_visible_masks_match_jax():
    """``tests/test_s3.py::TestVisibility``'s occluded scene at texture 64:
    the exact and face-granular masks equal JAX's; the depth test agrees with
    the exact one on > 93% of the texels and at least as well as the raster."""
    cams, verts, faces, uvs, _ = jsyn.make_scene(n_cams=2, nx=8, ny=8, width=64, height=64)
    cam = cams[0]
    toward = np.asarray(cam.camera_center) - verts.mean(axis=0)
    occ_v = verts + 0.3 * toward[None, :] + np.array([0.35, 0.0, 0.0], np.float32)
    all_v = np.concatenate([verts, occ_v]).astype(np.float32)
    all_f = np.concatenate([faces, faces + len(verts)])
    jbind, bind_map = JAG.build_binding(uvs, faces, 64)
    tbind, _ = TAG.build_binding(uvs, faces, 64, bind_map=bind_map, device="cpu")
    jv, jf = jnp.asarray(all_v), jnp.asarray(all_f.astype(np.int32))
    tv, tf = T(all_v), T(all_f)
    mats = dict(viewmatrix=T(np.asarray(cam.world_view_transform)),
                projmatrix=T(np.asarray(cam.full_proj_transform)),
                image_width=256, image_height=256)
    jmats = dict(viewmatrix=cam.world_view_transform, projmatrix=cam.full_proj_transform,
                 image_width=256, image_height=256)
    exact = TAG.get_visible_mask_exact(tbind, tv, tf, T(np.asarray(cam.camera_center))).numpy()
    raster = TAG.get_visible_mask_raster(tbind, tv, tf, **mats).numpy()
    depth = TAG.get_visible_mask_depth(tbind, tv, tf, **mats).numpy()
    inner = ~_on_edge(tbind)
    assert inner.mean() > 0.95
    np.testing.assert_array_equal(exact[inner], np.asarray(JAG.get_visible_mask_exact(
        jbind, jv, jf, cam.camera_center))[inner])
    np.testing.assert_array_equal(raster, np.asarray(JAG.get_visible_mask_raster(
        jbind, jv, jf, **jmats)))
    assert 0.05 < exact.mean() < 0.95
    agree_depth, agree_raster = (depth == exact).mean(), (raster == exact).mean()
    assert agree_depth > 0.93 and agree_depth >= agree_raster


RES, DEG, W, H, FRAMES = 32, 1, 64, 64, 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A synthetic garment with inset UVs (dead texels in the dense layout),
    its texels on an edge of their face transparent."""
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.training import checkpoints as tckpt

    root = tmp_path_factory.mktemp("gg_exact_vis")
    traj = root / "traj.pkl"
    info = write_inference_inputs(root / "output", traj, nx=8, ny=8, texture_size=RES,
                                  sh_degree=DEG, width=W, height=H, n_frames=FRAMES,
                                  uv_inset=0.1)
    assert 100 < info["n_texels"] < 0.8 * RES * RES
    stage3 = root / "output" / "garment" / "stage3"
    ck = tckpt.load_s3_ckpt(stage3)
    edge = T(_on_edge(TAG.build_binding(info["uvs"], info["faces"], RES, device="cpu")[0]))
    assert 0 < float(edge.float().mean()) < 0.1
    splats = ck["splats"].to("cpu")
    splats = splats.replace(opacity=torch.where(edge[:, None], -30.0, splats.opacity))
    tckpt.save_s3_ckpt(stage3, epoch=ck["epoch"], active_sh_degree=DEG, splats=splats,
                       net_params=ck["net_params"], net_buffers=ck["net_buffers"])
    return root, traj


def _jax_rows(traj, out_dir):
    from gaussian_garments_tpu.renderer import RasterConfig, render
    from gaussian_garments_tpu.utils.camera import camera_from_json_params

    sim = D.Simulation(str(traj), str(out_dir), sh_degree=DEG, texture_size=RES,
                       exact_visibility=True, dense_texels=True)
    with open(Path(DEFAULTS.output_root) / sim.garment_names[0] / "stage1" / "cameras.json") as f:
        params = json.load(f)
    cam = camera_from_json_params(params[sorted(params)[0]], h=H, w=W)
    body_f = jnp.asarray(np.asarray(sim.pkl["obstacle_faces"], np.int32))
    rows = []
    for idx in range(len(sim)):
        updates, vis = sim.forward(idx, cam)
        body_v = jnp.asarray(np.asarray(sim.pkl["obstacle"][idx], np.float32))
        mask, body_img = D.body_mask_and_image(body_v, body_f, [u["mesh_v"] for u in updates],
                                               [u["mesh_f"] for u in updates], cam)
        panels = []
        for key in ("shs", "raw_shs", "style"):
            out = render(cam, D.concat_bundle(updates, vis, DEG, override=key), jnp.zeros(3),
                         config=RasterConfig(backend="reference"))
            panels.append(D.composite_jnp(out["render"], out["alpha"][0], body_img, mask))
        row = jnp.concatenate(panels, axis=2).transpose(1, 2, 0)
        rows.append(np.asarray(jnp.clip(jnp.round(row * 255.0), 0, 255).astype(jnp.uint8)))
    return rows


def test_cli_exact_visibility_dense_texels(world, monkeypatch):
    """``inference --device cpu --exact_visibility --dense_texels``: the PNG
    rows of the JAX doll with the same flags, and the ray cast timed apart."""
    from PIL import Image

    from gaussian_garments_tpu_torch import inference

    root, traj = world
    monkeypatch.setattr(DEFAULTS, "output_root", str(root / "output"))
    monkeypatch.setattr(TORCH_DEFAULTS, "output_root", str(root / "output"))
    out = root / "render_cli"
    stats = inference.main(["--traj_path", str(traj), "--output_path", str(out),
                            "--device", "cpu", "--sh_degree", str(DEG), "--texture_size",
                            str(RES), "--width", str(W), "--height", str(H),
                            "--exact_visibility", "--dense_texels"])
    assert all(set(t) == {"bake_mesh_io_s", "render_s", "raycast_s", "png_s"}
               for t in stats["frames"])
    assert all(c > 0.1 for c in stats["coverage"])
    want = _jax_rows(traj, root / "jax_sim")
    for idx in range(FRAMES):
        row = np.asarray(Image.open(out / "renders" / f"{idx:05d}.png"))
        assert row.shape == (H, 3 * W, 3) and row.std() > 0
        diff = np.abs(row.astype(np.int16) - want[idx].astype(np.int16))
        assert diff.max() <= 1, (idx, diff.max(), (diff > 0).mean())
