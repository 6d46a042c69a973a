"""The inference slice of the PyTorch port against the JAX package, on the
CPU: the same garment, checkpoint and trajectory on disk go through the JAX
doll (exact per-pixel oracle, ``RasterConfig(backend="reference")``) and
through the port (``--device cpu``: the compositor's plain version), and the
PNG rows are compared; plus the port's CLI, and a check that the port imports
no JAX.

Tolerance: the uint8 rows differ by at most 1 level. Every stage before the
rounding agrees to ~1e-5 (see the other ``test_torch_*`` files), which can
move a value across a rounding boundary and no further.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.config import DEFAULTS
from gaussian_garments_tpu_torch.config import DEFAULTS as TORCH_DEFAULTS

REPO = Path(__file__).resolve().parent.parent
RES, DEG, W, H, FRAMES = 32, 1, 64, 64, 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One synthetic garment written by the port's writer: template, camera,
    a seeded ``net.pkl`` in the JAX layout, and a 2-frame trajectory."""
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs

    root = tmp_path_factory.mktemp("gg_torch_inference")
    out_root = root / "output"
    traj = root / "traj.pkl"
    info = write_inference_inputs(out_root, traj, nx=8, ny=8, texture_size=RES, sh_degree=DEG,
                                  width=W, height=H, n_frames=FRAMES)
    assert info["n_texels"] > 100
    return root, out_root, traj


@pytest.fixture
def output_root(world, monkeypatch):
    monkeypatch.setattr(DEFAULTS, "output_root", str(world[1]))
    monkeypatch.setattr(TORCH_DEFAULTS, "output_root", str(world[1]))
    return world


def _jax_rows(traj, out_dir):
    from gaussian_garments_tpu import doll as D
    from gaussian_garments_tpu.renderer import RasterConfig, render
    from gaussian_garments_tpu.utils.camera import camera_from_json_params
    import json

    sim = D.Simulation(str(traj), str(out_dir), sh_degree=DEG, texture_size=RES)
    with open(Path(DEFAULTS.output_root) / sim.garment_names[0] / "stage1" / "cameras.json") as f:
        params = json.load(f)
    cam = camera_from_json_params(params[sorted(params)[0]], h=H, w=W)
    cfg = RasterConfig(backend="reference")
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
                         config=cfg)
            panels.append(D.composite_jnp(out["render"], out["alpha"][0], body_img, mask))
        row = jnp.concatenate(panels, axis=2).transpose(1, 2, 0)
        rows.append(np.asarray(jnp.clip(jnp.round(row * 255.0), 0, 255).astype(jnp.uint8)))
    return rows


def test_slice_matches_jax(output_root):
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.doll import Simulation, concat_bundle
    from gaussian_garments_tpu_torch.renderer import RasterConfig, render

    root, _, traj = output_root
    args = inference.parse_args(["--traj_path", str(traj), "--output_path", "unused",
                                 "--width", str(W), "--height", str(H)])
    sim = Simulation(str(traj), str(root / "port_sim"), sh_degree=DEG, texture_size=RES,
                     device="cpu")
    cam = inference.load_camera(sim.garment_names[0], args, torch.device("cpu"))
    bg = torch.zeros(3)
    want = _jax_rows(traj, root / "jax_sim")
    for idx in range(FRAMES):
        row, timings, coverage = inference.render_frame(sim, idx, cam, bg, DEG, RasterConfig())
        assert row.shape == (H, 3 * W, 3) and row.dtype == np.uint8
        assert coverage > 0.1
        diff = np.abs(row.astype(np.int16) - want[idx].astype(np.int16))
        assert diff.max() <= 1, (idx, diff.max(), (diff > 0).mean())
        assert set(timings) == {"bake_mesh_io_s", "device_s"}
    with torch.no_grad():
        updates, vis = sim.forward(0, cam)
        aux = render(cam, concat_bundle(updates, vis, DEG), bg)["raster_aux"]
    assert int(aux["n_clipped"]) == 0 and int(aux["n_overflow"]) == 0


def _two_garment_updates(rng):
    """The same texel splats on two sheets, one in front of the other, as the
    JAX doll's and the port's per-garment update dicts."""
    from gaussian_garments_tpu.data import synthetic as jsyn
    from gaussian_garments_tpu.models import avatar_gaussian as JAG
    from gaussian_garments_tpu.models import gaussian as JG
    from gaussian_garments_tpu.models import mesh_gaussian as JMG
    from gaussian_garments_tpu_torch.data import synthetic as tsyn
    from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
    from gaussian_garments_tpu_torch.models import gaussian as TG
    from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG

    verts, faces, uvs = jsyn.make_cloth_template(6, 6)
    ring = dict(radius=0.4, height=2.2, width=W, height_px=H)
    jc, tc = jsyn.make_camera_ring(1, **ring)[0], tsyn.make_camera_ring(1, **ring, device="cpu")[0]
    toward = np.asarray(jc.camera_center) / np.linalg.norm(np.asarray(jc.camera_center))
    jbind, _ = JAG.build_binding(uvs, faces, RES)
    tbind, _ = TAG.build_binding(uvs, faces, RES, device="cpu")
    n = tbind.binding.shape[0]
    p = dict(xyz=rng.randn(n, 3) * 0.01, features_dc=rng.randn(n, 1, 3) * 0.3,
             features_rest=rng.randn(n, 3, 3) * 0.1, scaling=rng.randn(n, 3) * 0.2 - 4.5,
             rotation=rng.randn(n, 4), opacity=rng.randn(n, 1) + 2)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = TG.GaussianParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    jups, tups = [], []
    for shift in (0.3, 0.0):
        v = (verts + toward * shift + np.array([0.013, -0.021, 0.0])).astype(np.float32)
        for M, AG, G, bind, params, ups, arr, f in (
                (JMG, JAG, JG, jbind, jp, jups, jnp.asarray, faces.astype(np.int32)),
                (TMG, TAG, TG, tbind, tp, tups, torch.from_numpy, faces)):
            vv, ff = arr(v), arr(f)
            frames = M.compute_face_frames(vv, ff)
            anchor = AG.barycentric_3d(bind, vv, ff)
            ups.append({"xyz": AG.avatar_world_xyz(params.xyz, bind, frames, anchor),
                        "anchor": anchor,
                        "rotation": M.world_rotation(params, bind.binding, frames),
                        "scaling": M.world_scaling(params, bind.binding, frames),
                        "opacity": G.get_opacity(params), "shs": G.get_features(params),
                        "mesh_v": vv, "mesh_f": ff})
    return jc, tc, jups, tups


def test_doll_pieces_match_jax(rng):
    """Joint visibility over two garments, the body mask and image, the
    concatenated bundle and the final composite, piece by piece."""
    from gaussian_garments_tpu import doll as D
    from gaussian_garments_tpu.renderer import RasterConfig as JRasterConfig, render as jrender
    from gaussian_garments_tpu_torch import doll as TD
    from gaussian_garments_tpu_torch.renderer import render as trender

    jc, tc, jups, tups = _two_garment_updates(rng)
    jvis = np.asarray(D.joint_visibility_depth(jups, jc.world_view_transform,
                                               jc.full_proj_transform))
    tvis = TD.joint_visibility_depth(tups, tc.world_view_transform, tc.full_proj_transform)
    n = len(jvis) // 2
    assert jvis[:n].mean() > 0.8 and jvis[n:].mean() < 0.5
    np.testing.assert_array_equal(tvis.numpy(), jvis)

    body_v = (np.asarray(jups[1]["mesh_v"]) * 1.6 + np.array([0.0, 0.0, -0.05])).astype(np.float32)
    body_f = tups[1]["mesh_f"].numpy()
    jmask, jimg = D.body_mask_and_image(jnp.asarray(body_v), jnp.asarray(body_f.astype(np.int32)),
                                        [u["mesh_v"] for u in jups], [u["mesh_f"] for u in jups],
                                        jc)
    tmask, timg = TD.body_mask_and_image(torch.from_numpy(body_v), torch.from_numpy(body_f),
                                         [u["mesh_v"] for u in tups], [u["mesh_f"] for u in tups],
                                         tc)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=1e-6)

    jb = D.concat_bundle(jups, jnp.asarray(jvis), DEG)
    tb = TD.concat_bundle(tups, tvis, DEG)
    for f in ("means3d", "opacity", "scales", "rotations", "shs"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    jout = jrender(jc, jb, jnp.zeros(3), config=JRasterConfig(backend="reference"))
    tout = trender(tc, tb, torch.zeros(3))
    assert int(tout["raster_aux"]["n_clipped"]) == 0
    np.testing.assert_allclose(tout["render"].numpy(), np.asarray(jout["render"]), atol=2e-5)
    np.testing.assert_array_equal(tout["radii"].numpy(), np.asarray(jout["radii"]))
    got = TD.composite(tout["render"], tout["alpha"][0], timg, tmask)
    want = D.composite_jnp(jout["render"], jout["alpha"][0], jimg, jmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_split_vertices_two_garments(output_root):
    from gaussian_garments_tpu_torch.doll import Garment, Simulation

    sim = object.__new__(Simulation)
    verts = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    g = Garment(name="g", template={"vertices": verts}, faces=None, bind=None, splats=None,
                net=None, sh_degree=0)
    sim.garments = [g, g._replace(template={"vertices": verts[:4]})]
    out = sim.split_vertices(np.concatenate([verts, verts[:4] + 1.0]))
    np.testing.assert_array_equal(out[0], verts)
    np.testing.assert_array_equal(out[1], verts[:4] + 1.0)


def test_cli_on_cpu(output_root):
    """``python -m gaussian_garments_tpu_torch.inference`` with ``--device cpu``
    writes one ``shs | raw_shs | style`` row per frame."""
    from PIL import Image

    from gaussian_garments_tpu_torch import inference

    root, _, traj = output_root
    out = root / "render_cli"
    stats = inference.main(["--traj_path", str(traj), "--output_path", str(out),
                            "--device", "cpu", "--sh_degree", str(DEG),
                            "--texture_size", str(RES), "--width", str(W), "--height", str(H)])
    pngs = sorted((out / "renders").glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:05d}.png" for i in range(FRAMES)]
    for p in pngs:
        img = np.asarray(Image.open(p))
        assert img.shape == (H, 3 * W, 3) and img.std() > 0
    assert stats["device"] == "cpu" and len(stats["frames"]) == FRAMES
    assert all(c > 0 for c in stats["coverage"])


def test_cuda_device_without_gpu_raises(monkeypatch):
    """No silent CPU fallback: asking for cuda without a GPU is an error."""
    from gaussian_garments_tpu_torch import inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        inference.resolve_device("cuda")
    assert inference.parse_args(["--traj_path", "t", "--output_path", "o"]).device == "cuda"


def test_port_imports_no_jax():
    """Every module of the port imports with jax, flax, orbax and the JAX
    package ``gaussian_garments_tpu`` blocked, and none of them is loaded."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'orbax', 'gaussian_garments_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gaussian_garments_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import gaussian_garments_tpu_torch.inference, gaussian_garments_tpu_torch.s2_registration\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
