"""Stage 3's modules on the CPU, the port against the JAX package on the same
inputs: the texel-splat functions of ``models/avatar_gaussian.py``
(``local_offset``, ``scatter_texture``, ``init_from_template``,
``get_visible_mask_depth``) and the items of ``data/readers.AvatarDataset``.

Tolerances:
- ``scatter_texture``, ``init_from_template`` (copies of the nearest
  Template splat), the dataset's item order, images, masks, backgrounds and
  mesh vertices: exact;
- ``local_offset`` and the camera matrices: atol 1e-6 (the same float32
  expressions, evaluated by XLA and by PyTorch);
- the AO and normal bake: atol 1e-6, as ``tests/test_torch_avatar_net.py``
  holds the baker (the same hemisphere directions and the same BVH);
- the depth-buffer visibility: equal on at least 99.5% of the texels. A
  texel whose anchor lies within float32 rounding of a pixel-centre boundary
  or of the 5e-3 relative depth gate can fall either way.
"""
import random
import shutil
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu import config as jcfg
from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.data.readers import AvatarDataset as JDataset
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu_torch import config as tcfg
from gaussian_garments_tpu_torch.data import synthetic as tsyn
from gaussian_garments_tpu_torch.data.readers import AvatarDataset as TDataset
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG
from gaussian_garments_tpu_torch.utils.io import write_obj

RES = 32


@pytest.fixture(scope="module")
def sheet():
    cams, verts, faces, uvs, _ = jsyn.make_scene(n_cams=2, nx=8, ny=8, width=64, height=64)
    jbind, _ = JAG.build_binding(uvs, faces, RES)
    tbind, _ = TAG.build_binding(uvs, faces, RES, device="cpu")
    return cams, verts, faces, jbind, tbind


def _frames(verts, faces, rng):
    v = (verts + rng.randn(*verts.shape) * 0.01).astype(np.float32)
    jf = JMG.compute_face_frames(jnp.asarray(v), jnp.asarray(faces.astype(np.int32)))
    tf = TMG.compute_face_frames(torch.from_numpy(v), torch.from_numpy(faces.astype(np.int64)))
    return v, jf, tf


def test_local_offset_matches_jax(sheet):
    _, verts, faces, jbind, tbind = sheet
    rng = np.random.RandomState(0)
    _, jf, tf = _frames(verts, faces, rng)
    gs_3d = rng.randn(int(jbind.binding.shape[0]), 3).astype(np.float32) * 0.2
    want = np.asarray(JAG.local_offset(jbind, jf, jnp.asarray(gs_3d)))
    got = TAG.local_offset(tbind, tf, torch.from_numpy(gs_3d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and back: the world position of that offset is the anchor given
    back = TAG.avatar_world_xyz(got, tbind, tf, torch.zeros_like(got))
    rows = TMG.gather_frame_rows(tf, tbind.binding)
    np.testing.assert_allclose((back + rows[:, TMG.FR_C]).numpy(), gs_3d, rtol=0, atol=1e-5)


def test_scatter_texture_matches_jax(sheet):
    _, _, _, jbind, tbind = sheet
    vals = np.random.RandomState(1).randn(int(jbind.binding.shape[0]), 5).astype(np.float32)
    want = np.asarray(JAG.scatter_texture(jbind, jnp.asarray(vals), 5))
    got = TAG.scatter_texture(tbind, torch.from_numpy(vals), 5)
    assert got.shape == (5, RES, RES)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TAG.gather_texture(tbind, got).numpy(), vals)


@pytest.mark.parametrize("max_sh_degree", [0, 2])
def test_init_from_template_matches_jax(sheet, tmp_path, max_sh_degree):
    """Stage 2 writes its Template at SH degree 0; at degree 2 both packages
    start the higher coefficients at zero."""
    _, verts, faces, jbind, tbind = sheet
    rng = np.random.RandomState(2)
    params, _, binding, _ = TMG.create_from_template(
        verts, faces, rng.rand(len(faces), 3).astype(np.float32), 0, device="cpu")
    n = params.xyz.shape[0]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    params = params.replace(
        xyz=t(rng.randn(n, 3) * 0.1), features_dc=t(rng.randn(n, 1, 3)),
        scaling=t(rng.randn(n, 3) * 0.3 - 5.0), rotation=t(rng.randn(n, 4)),
        opacity=t(rng.randn(n, 1)))
    frames = TMG.compute_face_frames(torch.from_numpy(verts), torch.from_numpy(faces))
    world = TMG.local_to_world(params, torch.from_numpy(binding), frames)
    TG.save_ply(tmp_path / "local_point_cloud.ply", params)
    TG.save_ply(tmp_path / "point_cloud.ply", world)
    paths = (str(tmp_path / "point_cloud.ply"), str(tmp_path / "local_point_cloud.ply"))
    jp, jaux = JAG.init_from_template(jbind, verts, faces, *paths, max_sh_degree)
    tp, taux = TAG.init_from_template(tbind, verts, faces, *paths, max_sh_degree, device="cpu")
    for k in TG.PARAM_NAMES:
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    assert tp.features_rest.shape == (tbind.binding.shape[0], (max_sh_degree + 1) ** 2 - 1, 3)
    assert bool(taux.alive.all()) and float(taux.denom.abs().sum()) == 0.0
    # texels draw from many Template splats, not one
    assert len(np.unique(tp.features_dc.numpy()[:, 0, 0])) > len(faces) // 2


def test_visible_mask_depth_matches_jax(sheet):
    """``tests/test_s3.py``'s half-occluded scene: the sheet and a copy of it
    pushed toward the camera, at 256²."""
    cams, verts, faces, jbind, tbind = sheet
    cam = cams[0]
    toward = np.asarray(cam.camera_center) - verts.mean(axis=0)
    occ_v = verts + 0.3 * toward[None, :] + np.array([0.35, 0.0, 0.0], np.float32)
    all_v = np.concatenate([verts, occ_v]).astype(np.float32)
    all_f = np.concatenate([faces, faces + len(verts)])
    wv, fp = np.array(cam.world_view_transform), np.array(cam.full_proj_transform)
    want = np.asarray(JAG.get_visible_mask_depth(
        jbind, jnp.asarray(all_v), jnp.asarray(all_f.astype(np.int32)), jnp.asarray(wv),
        jnp.asarray(fp), image_width=256, image_height=256))
    got = TAG.get_visible_mask_depth(
        tbind, torch.from_numpy(all_v), torch.from_numpy(all_f.astype(np.int64)),
        torch.from_numpy(wv), torch.from_numpy(fp), image_width=256, image_height=256)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert 0.05 < want.mean() < 0.95
    assert (got.numpy() == want).mean() >= 0.995


# ---------------------------------------------------------------------------
# AvatarDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Two sequences of 2 frames and 5 cameras (llffhold 4: cameras 0 and 4
    held out), the stage-2 meshes written as stage 2 writes them, and one
    output tree per package, so that each bakes its own AO and normals."""
    root = tmp_path_factory.mktemp("s3data")
    data, out = root / "data", root / "out_port"
    for seq in ("seqA", "seqB"):
        info = tsyn.write_reference_layout(data, out, "subj", seq, n_cams=5, n_frames=2, nx=6,
                                           ny=6, res=48, device="cpu")
        meshes = out / "subj" / "stage2" / seq / "meshes"
        meshes.mkdir(parents=True)
        for t, v in enumerate(info["frames"]):
            write_obj({"vertices": v, "faces": info["faces"]}, meshes / f"frame_{t:05d}.obj")
    shutil.copytree(out, root / "out_jax")
    return root, info


def _args(out_root):
    return Namespace(subject="subj", subject_out=str(out_root / "subj"), white_background=False,
                     random_bg=True, blur_mask=True, texture_size=RES, shuffle=True, eval=True,
                     llffhold=4)


def test_avatar_dataset_matches_jax(layout, monkeypatch):
    root, info = layout
    for cfg in (jcfg, tcfg):
        monkeypatch.setattr(cfg.DEFAULTS, "data_root", str(root / "data"))
    jbind, _ = JAG.build_binding(info["uvs"], info["faces"], RES)
    tbind, _ = TAG.build_binding(info["uvs"], info["faces"], RES, device="cpu")
    jds = JDataset(_args(root / "out_jax"), bind=jbind)
    tds = TDataset(_args(root / "out_port"), bind=tbind, device="cpu")

    # the split and the per-epoch order
    assert len(tds) == len(jds) == 2 * 2 * 3
    assert tds.eval_collection == jds.eval_collection
    assert {c for _, _, c in tds.eval_collection} == {"Cam000", "Cam004"}
    for epoch in (1, 2):
        jds.reshuffle(epoch)
        tds.reshuffle(epoch)
        assert tds.frame_collection == jds.frame_collection
        items = list(tds._all_items)
        random.Random(31359 + epoch).shuffle(items)
        assert tds.frame_collection == items
    assert tds.frame_collection != sorted(tds.frame_collection)

    # items: the same numpy seed draws the same random background
    loads = [(lambda d, i=i: d[i]) for i in (0, 5)] + [lambda d: d.eval_item(3)]
    for k, load in enumerate(loads):
        np.random.seed(100 + k)
        j = load(jds)
        np.random.seed(100 + k)
        t = load(tds)
        assert (t["current_seq"], t["current_frame"]) == (j["current_seq"], j["current_frame"])
        np.testing.assert_array_equal(t["bg"], j["bg"])
        tc, jc = t["camera"], j["camera"]
        assert tc.image_name == jc.image_name
        for a in ("original_image", "gt_alpha_mask"):
            np.testing.assert_array_equal(getattr(tc, a).numpy(), np.asarray(getattr(jc, a)), a)
        for a in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(getattr(tc, a).numpy(), np.asarray(getattr(jc, a)),
                                       rtol=0, atol=1e-6, err_msg=a)
        assert (tc.tanfovx, tc.tanfovy) == pytest.approx((jc.tanfovx, jc.tanfovy), abs=1e-7)
        assert tc.original_image.shape == (3, 48, 48)
        np.testing.assert_array_equal(t["mesh_v"], j["mesh_v"])
        for a in ("ambient", "normal"):
            np.testing.assert_allclose(t[a], np.asarray(j[a]), rtol=0, atol=1e-6, err_msg=a)
        assert 0.0 < float(t["ambient"].mean()) < 1.0
    # each bake was cached per frame in its own tree
    for tree in ("out_port", "out_jax"):
        cache = root / tree / "subj" / "stage2" / "seqA" / "texture"
        assert sorted(p.name for p in cache.iterdir())[:1] == ["frame_00000.npz"]
