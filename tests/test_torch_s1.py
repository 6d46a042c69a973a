"""Stage 1 of the PyTorch port against the JAX package on the same seeded
inputs: the meshing primitives, ``post_process``, ``parse_scan``,
``prepare_dataset``, ``colmap_recon`` and both drivers end to end.

Tolerances, with their reasons:
- normals, SurfaceNets, components, remesh, ``parse_scan`` labels: exact
  (the same numpy code); ``parse_scan``'s vote shares: at most 0.1% of the
  vertices differ (edge pixels that the two float32 rasters assign apart);
- ``poisson_indicator``: χ within 1e-5 × max|χ|, iso within 1e-5 relative
  (complex64 FFTs of two libraries);
- ``post_process`` and the drivers' templates: faces equal and vertices within
  1e-5 m (the Poisson solve's float32 differences, through SurfaceNets'
  interpolation and the remesh's centroids);
- ``prepare_dataset``: the same files and bytes, the numbers of the COLMAP
  text model within 1e-6 (the float32 quaternion).
"""
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from gaussian_garments_tpu.stages import meshing as JM
from gaussian_garments_tpu.stages import s1 as JS1
from gaussian_garments_tpu_torch.stages import meshing as TM
from gaussian_garments_tpu_torch.stages import s1 as TS1
from test_e2e import _uv_sphere
from test_meshing import _sphere_cloud

CPU = torch.device("cpu")


def _same_mesh(got, want, atol=1e-5):
    (gv, gf), (wv, wf) = got, want
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# meshing primitives (tests/test_meshing.py's sphere cloud)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    """The sphere cloud, the JAX package's normals and indicator at 64³."""
    pts, _ = _sphere_cloud(8000)
    normals = JM.estimate_normals(pts)
    chi, p01, iso, origin_scale = JM.poisson_indicator(pts, normals, res=64)
    return pts, normals, chi, iso, origin_scale


def test_estimate_normals_match_jax(sphere):
    pts, normals = sphere[:2]
    np.testing.assert_array_equal(TM.estimate_normals(pts), normals)


def test_poisson_indicator_matches_jax(sphere):
    pts, normals, chi, iso, origin_scale = sphere
    t_chi, t_p01, t_iso, t_os = TM.poisson_indicator(pts, normals, res=64, device="cpu")
    assert t_chi.dtype == np.float32 and t_chi.shape == chi.shape
    np.testing.assert_allclose(t_chi, chi, rtol=0, atol=1e-5 * np.abs(chi).max())
    assert abs(t_iso - iso) <= 1e-5 * abs(iso)
    np.testing.assert_array_equal(t_os[0], origin_scale[0])
    assert t_os[1] == origin_scale[1]


def test_surface_nets_components_remesh_match_jax(sphere):
    chi, iso, origin_scale = sphere[2:]
    want = JM.surface_nets(chi, iso, origin_scale)
    got = TM.surface_nets(chi, iso, origin_scale)
    _same_mesh(got, want, atol=0)
    want, got = JM.largest_component(*want), TM.largest_component(*got)
    _same_mesh(got, want, atol=0)
    # a stray triangle, so that largest_component drops something
    v = np.concatenate([want[0], np.eye(3, dtype=np.float32) * 9])
    f = np.concatenate([want[1], len(want[0]) + np.array([[0, 1, 2]])])
    _same_mesh(TM.largest_component(v, f), JM.largest_component(v, f), atol=0)
    np.testing.assert_array_equal(TM.farthest_point_sampling(want[0], 300, seed=2),
                                  JM.farthest_point_sampling(want[0], 300, seed=2))
    _same_mesh(TM.cluster_remesh(*got, target_faces=1000),
               JM.cluster_remesh(*want, target_faces=1000), atol=0)


# ---------------------------------------------------------------------------
# post_process (tests/test_meshing.py::TestPostProcessEndToEnd's cloud)
# ---------------------------------------------------------------------------

def _write_fused(path):
    from gaussian_garments_tpu_torch.utils.io import store_ply

    pts, _ = _sphere_cloud(40000, noise=0.002)
    pts = pts * 0.3
    colors = np.full((len(pts), 3), 128, np.float32)
    junk = np.random.RandomState(1).rand(2000, 3).astype(np.float32) * 2 - 1
    junk_c = np.tile(np.array([[20, 230, 20]], np.float32), (len(junk), 1))
    store_ply(path, np.concatenate([pts, junk]), np.concatenate([colors, junk_c]))


def test_post_process_matches_jax(tmp_path):
    from gaussian_garments_tpu_torch.utils.io import read_obj, read_ply

    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        _write_fused(tmp_path / pkg / "fused.ply")
    JS1.post_process(tmp_path / "jax", tmp_path / "jax", remesh_faces=2000, grid_res=96)
    TS1.post_process(tmp_path / "port", tmp_path / "port", remesh_faces=2000, grid_res=96,
                     device="cpu")
    for name in ("poisson.obj", "template.obj"):
        got, want = (read_obj(tmp_path / pkg / name) for pkg in ("port", "jax"))
        _same_mesh((got["vertices"], got["faces"]), (want["vertices"], want["faces"]))
    got, want = (read_ply(tmp_path / pkg / "point_cloud.ply") for pkg in ("port", "jax"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 1200 <= len(read_obj(tmp_path / "port" / "template.obj")["faces"]) <= 2200


# ---------------------------------------------------------------------------
# prepare_dataset and colmap_recon
# ---------------------------------------------------------------------------

def _write_capture(seq, n_cams=3, res=64):
    """``TestS1Driver``'s capture (tests/test_e2e.py): a UV sphere whose top
    half is the garment, seen by a ring of cameras; masks from the port's
    rasterizer. Returns the cameras."""
    from gaussian_garments_tpu_torch.data.synthetic import make_camera_ring
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
    from gaussian_garments_tpu_torch.utils.io import save_image

    verts, faces = _uv_sphere()
    top_faces = verts[faces].mean(1)[:, 2] > 0.0
    cams = make_camera_ring(n_cams, fx=100.0, width=res, height_px=res, device="cpu")
    cam_json = {}
    for k, cam in enumerate(cams):
        name = f"Cam{k:03d}"
        intr = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
        extr = np.concatenate([cam.R.T, np.asarray(cam.T)[:, None]], axis=1)
        cam_json[name] = {"intrinsics": intr.tolist(), "extrinsics": extr.tolist(), "ids": k}
        p2f, _ = rasterize_mesh(torch.as_tensor(verts), torch.as_tensor(faces),
                                cam.world_view_transform, cam.full_proj_transform,
                                image_width=res, image_height=res)
        p2f = p2f.numpy()
        fg = (p2f >= 0).astype(np.float32)
        gm = np.zeros_like(fg)
        gm[p2f >= 0] = top_faces[p2f[p2f >= 0]].astype(np.float32)
        save_image(seq / name / "rgb_images" / "00000.png", np.stack([fg * 0.5] * 3, -1))
        save_image(seq / name / "garment_masks" / "00000.png", gm)
        save_image(seq / name / "foreground_masks" / "00000.png", fg)
    with open(seq / "cameras.json", "w") as f:
        json.dump(cam_json, f)
    return cams


def _numbers(path):
    return [[float(x) for x in line.split() if _is_number(x)]
            for line in path.read_text().splitlines()]


def _is_number(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def test_prepare_dataset_matches_jax(tmp_path):
    seq = tmp_path / "data"
    _write_capture(seq)
    JS1.prepare_dataset(seq, tmp_path / "jax")
    TS1.prepare_dataset(seq, tmp_path / "port", device="cpu")
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert "masks/Cam002.png.png" in files(tmp_path / "port")
    for rel in files(tmp_path / "jax"):
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if got.is_dir():
            continue
        if rel in ("sparse_known/cameras.txt", "sparse_known/images.txt"):
            g, w = _numbers(got), _numbers(want)
            assert [len(x) for x in g] == [len(x) for x in w]
            np.testing.assert_allclose(sum(g, []), sum(w, []), rtol=0, atol=1e-6, err_msg=rel)
            assert [l.split()[-1:] for l in got.read_text().splitlines()] == \
                [l.split()[-1:] for l in want.read_text().splitlines()]
        else:
            assert got.read_bytes() == want.read_bytes(), rel


@pytest.fixture
def fake_colmap(tmp_path, monkeypatch):
    """A ``colmap`` on PATH that appends its argv to a log and exits with
    ``FAKE_COLMAP_RC`` when its subcommand is ``FAKE_COLMAP_FAIL``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text(f"#!{sys.executable}\n"
                   "import json, os, sys\n"
                   "with open(os.environ['FAKE_COLMAP_LOG'], 'a') as f:\n"
                   "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
                   "if sys.argv[1] == os.environ.get('FAKE_COLMAP_FAIL'):\n"
                   "    sys.exit(int(os.environ['FAKE_COLMAP_RC']))\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    log = tmp_path / "colmap.log"
    monkeypatch.setenv("FAKE_COLMAP_LOG", str(log))

    def calls():
        lines = log.read_text().splitlines() if log.exists() else []
        log.unlink(missing_ok=True)
        return [json.loads(line) for line in lines]

    return calls


@pytest.mark.parametrize("skip_dense", [False, True])
def test_colmap_recon_same_commands(tmp_path, fake_colmap, skip_dense):
    JS1.colmap_recon(tmp_path / "t", skip_dense=skip_dense)
    want = fake_colmap()
    TS1.colmap_recon(tmp_path / "t", skip_dense=skip_dense)
    got = fake_colmap()
    assert got == want and len(want) == (3 if skip_dense else 6)
    assert (tmp_path / "t" / "sparse").is_dir()


def test_colmap_recon_same_exit_code(tmp_path, fake_colmap, monkeypatch):
    monkeypatch.setenv("FAKE_COLMAP_FAIL", "point_triangulator")
    monkeypatch.setenv("FAKE_COLMAP_RC", "7")
    codes = []
    for recon in (JS1.colmap_recon, TS1.colmap_recon):
        with pytest.raises(SystemExit) as e:
            recon(tmp_path / "t")
        codes.append((e.value.code, fake_colmap()))
    assert codes[0] == codes[1] and codes[0][0] == 7 and len(codes[0][1]) == 3


# ---------------------------------------------------------------------------
# both drivers on TestS1Driver's scene, then parse_scan on its scan
# ---------------------------------------------------------------------------

ARGV = ["-s", "subj", "-q", "seq1", "--skip_colmap", "--grid_res", "64", "--remesh_faces", "500"]


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """Both drivers run on one capture with a planted ``fused.ply``, each
    into its own output root. Returns {package: stage1 dir} and the port's
    result dict."""
    import s1_initialisation as jdriver
    from gaussian_garments_tpu.config import DEFAULTS as JD
    from gaussian_garments_tpu_torch import s1_initialisation as tdriver
    from gaussian_garments_tpu_torch.config import DEFAULTS as TD
    from gaussian_garments_tpu_torch.utils.io import store_ply

    root = tmp_path_factory.mktemp("s1")
    _write_capture(root / "data" / "subj" / "seq1")
    dense_v, dense_f = _uv_sphere(n_theta=48, n_phi=96)
    cloud = np.concatenate([dense_v, dense_v[dense_f].mean(1)])
    saved = [(d, d.data_root, d.output_root) for d in (JD, TD)]
    out, result = {}, None
    try:
        for pkg, defaults in (("jax", JD), ("port", TD)):
            defaults.data_root, defaults.output_root = str(root / "data"), str(root / pkg)
            out[pkg] = root / pkg / "subj" / "stage1"
            out[pkg].mkdir(parents=True)
            store_ply(out[pkg] / "fused.ply", cloud, np.full_like(cloud, 128.0))
        old = sys.argv
        sys.argv = ["s1_initialisation.py"] + ARGV
        try:
            jdriver.main()
        finally:
            sys.argv = old
        result = tdriver.main(ARGV + ["--device", "cpu"])
    finally:
        for d, data, output in saved:
            d.data_root, d.output_root = data, output
    return out, result


def test_drivers_same_artifacts_and_template(drivers):
    from gaussian_garments_tpu_torch.utils.io import read_obj

    out, result = drivers
    names = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*"))
    assert names(out["port"]) == names(out["jax"])
    assert sorted(result["artifacts"]) == sorted(
        n for n in names(out["jax"]) if "/" not in n and n != "fused.ply")
    for name in ("poisson.obj", "segmented.obj", "parser.obj", "template.obj"):
        got, want = (read_obj(out[pkg] / name) for pkg in ("port", "jax"))
        _same_mesh((got["vertices"], got["faces"]), (want["vertices"], want["faces"]))
    np.testing.assert_array_equal(np.load(out["port"] / "segmented_labels.npy"),
                                  np.load(out["jax"] / "segmented_labels.npy"))
    tmpl = read_obj(out["port"] / "template.obj")
    assert len(tmpl["faces"]) > 0 and tmpl["vertices"][:, 2].min() > -0.1
    split = result["split"]
    assert len(split["parse_scan"]) == 3 and len(split["fps"]) == 1
    assert {"export", "load_masks", "filter", "normals", "splat", "fft_solve", "iso",
            "surface_nets", "largest_component", "remesh"} <= set(split)


def test_parse_scan_labels_match_jax(drivers):
    """Camera 0 on the JAX driver's scan (the drivers' test holds the labels
    of all three cameras): labels equal; the vote shares may differ at a few
    vertices, from edge pixels that the two float32 rasters assign apart."""
    from gaussian_garments_tpu_torch.utils.io import read_obj

    out = drivers[0]
    scan = read_obj(out["jax"] / "poisson.obj")
    j_cams, masks = JS1.load_segmentation_inputs(out["jax"])
    t_cams, t_masks = TS1.load_segmentation_inputs(out["port"], device="cpu")
    for a, b in zip(masks, t_masks):
        np.testing.assert_array_equal(a, b)
    want = JS1.parse_scan(scan["vertices"], scan["faces"], j_cams[:1], masks[:1])
    got = TS1.parse_scan(scan["vertices"], scan["faces"], t_cams[:1], t_masks[:1], device="cpu")
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert (got != want).mean() <= 1e-3
    assert 0.05 < (want > 0.5).mean() < 0.5


def test_driver_device_defaults_to_cuda(tmp_path):
    from gaussian_garments_tpu_torch import s1_initialisation as tdriver

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(["-s", "subj", "-q", "seq1", "--skip_colmap"])
