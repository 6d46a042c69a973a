"""The rest of stage 2's geometry API in the PyTorch port against the JAX
package on the same seeded inputs: ICP, the COLMAP readers,
``CrossScene.sparse_icp``, the three ARAP terms and ``Scene.arap_cache``,
and the plain model's covariance, LR schedules, densification statistics and
``densify_and_prune``.

Tolerances, with their reasons:
- ICP, COLMAP readers, ``arap_cache``: exact (the same numpy code);
- ``sparse_icp``: 1e-6 m (the same numpy ICP; the float32 cast of the moved
  vertices);
- ARAP values and gradients (torch autograd against ``jax.grad``): rtol 1e-5,
  atol 1e-7 (float32, summation order);
- covariance: rtol 1e-5; statistics: exact;
- LR schedules: rtol 1e-6 for the scheduled xyz rate (XLA's and numpy's
  float32 exp and log differ in the last bit), the constant rates exact;
- ``densify_and_prune``: identical counts (same ``RandomState``), arrays to
  1e-6.
"""
import struct
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.ops import icp as JICP
from gaussian_garments_tpu.utils import colmap as JCM
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG
from gaussian_garments_tpu_torch.ops import icp as TICP
from gaussian_garments_tpu_torch.utils import colmap as TCM

T = torch.from_numpy
CPU = torch.device("cpu")


def close(a, b, rtol=1e-5, atol=1e-7, err_msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=err_msg)


def _rotation(rotvec):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rotvec).as_matrix()


# ---------------------------------------------------------------------------
# ICP (tests/test_aux.py::TestICP's cases)
# ---------------------------------------------------------------------------

def _icp_case(name, rng):
    if name == "kabsch":
        src = rng.randn(100, 3)
        dst = src @ _rotation([0.2, -0.1, 0.4]).T + np.array([0.3, 1.0, -0.5])
        return lambda m: m.kabsch(src, dst)
    if name == "registration_icp":
        pts = rng.rand(500, 3) * 2
        target = pts @ _rotation([0.05, 0.08, -0.04]).T + np.array([0.05, -0.02, 0.03])
        return lambda m: m.transform_points(
            pts, m.registration_icp(pts, target, max_correspondence_distance=1.0))
    pts = np.concatenate([rng.rand(1000, 3) * 0.1, np.array([[10.0, 10, 10]])])
    if name == "voxel_downsample":
        return lambda m: m.voxel_downsample(pts, 0.02)
    down = JICP.voxel_downsample(pts, 0.02)
    return lambda m: m.remove_radius_outliers(down, nb_points=3, radius=0.05)


@pytest.mark.parametrize("name", ["kabsch", "registration_icp", "voxel_downsample",
                                  "remove_radius_outliers"])
def test_icp_matches_jax(rng, name):
    run = _icp_case(name, rng)
    got, want = run(TICP), run(JICP)
    assert got.shape == want.shape and len(want) > 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# COLMAP readers
# ---------------------------------------------------------------------------

def _write_colmap_model(d, rng):
    """A two-camera, two-image, 17-point binary model plus its points3D.txt."""
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 940, 1280) + struct.pack("<dddd", *rng.rand(4)))
        f.write(struct.pack("<iiQQ", 2, 4, 64, 48) + struct.pack("<" + "d" * 8, *rng.rand(8)))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for img_id, name in ((1, "Cam000.png"), (2, "Cam001.png")):
            f.write(struct.pack("<i", img_id) + struct.pack("<dddd", *rng.randn(4))
                    + struct.pack("<ddd", *rng.randn(3)) + struct.pack("<i", img_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 3))
            for k in range(3):
                f.write(struct.pack("<ddq", *rng.rand(2), k - 1))
    n = 17
    xyz, rgb, err = rng.randn(n, 3), rng.randint(0, 255, (n, 3)), rng.rand(n)
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i].astype(np.uint8), err[i]))
            f.write(struct.pack("<Q", 2) + struct.pack("<iiii", 0, 0, 1, 2))
    with open(d / "points3D.txt", "w") as f:
        f.write("# 3D point list\n")
        for i in range(n):
            f.write(f"{i} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} {rgb[i, 0]} {rgb[i, 1]} "
                    f"{rgb[i, 2]} {err[i]} 0 0 1 2\n")


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("reader,file", [("read_cameras_binary", "cameras.bin"),
                                         ("read_images_binary", "images.bin"),
                                         ("read_points3D_binary", "points3D.bin"),
                                         ("read_points3D_text", "points3D.txt")])
def test_colmap_readers_match_jax(tmp_path, rng, reader, file):
    _write_colmap_model(tmp_path, rng)
    got, want = getattr(TCM, reader)(tmp_path / file), getattr(JCM, reader)(tmp_path / file)
    _same(got, want)
    if reader == "read_images_binary":
        assert got[1].name == "Cam000.png" and list(got[2].point3D_ids) == [-1, 0, 1]


def test_qvec2rotmat_matches_jax(rng):
    for q in [np.array([1.0, 0, 0, 0])] + list(rng.randn(5, 4)):
        q = q / np.linalg.norm(q)
        np.testing.assert_array_equal(TCM.qvec2rotmat(q), JCM.qvec2rotmat(q))


# ---------------------------------------------------------------------------
# CrossScene.sparse_icp
# ---------------------------------------------------------------------------

def _write_sparse_points(path, xyz):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, p in enumerate(xyz):
            f.write(struct.pack("<QdddBBBd", i, *p, 128, 128, 128, 0.5))
            f.write(struct.pack("<Q", 0))


def _sparse_dataset(tmp_path):
    """A two-camera capture at 16² in the reference layout, and a stage-1
    sparse cloud: 3,000 points on a 0.4 m sphere."""
    from gaussian_garments_tpu_torch.utils.io import save_image

    rng = np.random.RandomState(4)
    seq = tmp_path / "data" / "subj" / "seq1"
    cams = {}
    for k in range(2):
        name = f"Cam{k:03d}"
        R = _rotation(rng.randn(3) * 0.3)
        cams[name] = {"intrinsics": [[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]],
                      "extrinsics": np.concatenate([R, rng.randn(3, 1)], 1).tolist()}
        fg = (rng.rand(16, 16) > 0.3).astype(np.float32)
        save_image(seq / name / "rgb_images" / "00000.png", rng.rand(16, 16, 3))
        save_image(seq / name / "garment_masks" / "00000.png", fg * (rng.rand(16, 16) > 0.5))
        save_image(seq / name / "foreground_masks" / "00000.png", fg)
    import json

    (seq / "cameras.json").write_text(json.dumps(cams))
    d = rng.randn(3000, 3)
    cloud = 0.4 * d / np.linalg.norm(d, axis=1, keepdims=True)
    _write_sparse_points(tmp_path / "out" / "subj" / "stage1" / "sparse" / "points3D.bin", cloud)
    return cloud


def test_sparse_icp_matches_jax(tmp_path, monkeypatch):
    from gaussian_garments_tpu import scene as JS
    from gaussian_garments_tpu.config import DEFAULTS as JD
    from gaussian_garments_tpu.stages import s1 as JS1
    from gaussian_garments_tpu_torch import scene as TS
    from gaussian_garments_tpu_torch.config import DEFAULTS as TD
    from gaussian_garments_tpu_torch.stages import s1 as TS1

    cloud = _sparse_dataset(tmp_path)
    R, t = _rotation([0.03, -0.05, 0.02]), np.array([0.01, 0.02, -0.015])
    calls = []

    def fake_colmap(target_root, gpu=False, skip_dense=False):
        calls.append(skip_dense)
        _write_sparse_points(target_root / "sparse" / "points3D.bin", cloud @ R.T + t)

    template = np.random.RandomState(6).randn(50, 3).astype(np.float32) * 0.3
    out = {}
    for pkg, scene_mod, s1_mod, defaults in (("jax", JS, JS1, JD), ("port", TS, TS1, TD)):
        monkeypatch.setattr(defaults, "data_root", str(tmp_path / "data"))
        monkeypatch.setattr(defaults, "output_root", str(tmp_path / "out"))
        monkeypatch.setattr(s1_mod, "colmap_recon", fake_colmap)
        args = SimpleNamespace(subject="subj", sequence="seq1",
                               subject_out=str(tmp_path / "out" / "subj"))
        scene = scene_mod.CrossScene(args, SimpleNamespace(device=CPU))
        out[pkg] = scene.sparse_icp(template)
        assert not (scene.stage2_path() / "colmap").exists()
    assert calls == [True, True]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=1e-6)
    # the ICP found the planted motion
    np.testing.assert_allclose(out["port"], template @ R.T + t, rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# ARAP terms and Scene.arap_cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def arap_case():
    """A 0.1 m 8×8 sheet with two splats per face after ``post_each_frame``
    in both packages; then moved splats and vertices for the current frame."""
    from gaussian_garments_tpu import scene as JS
    from gaussian_garments_tpu.data.synthetic import make_cloth_template
    from gaussian_garments_tpu_torch import scene as TS

    rng = np.random.RandomState(11)
    vt, f, _ = make_cloth_template(8, 8, size=0.1)
    binding = np.concatenate([np.arange(len(f)), rng.randint(0, len(f), 40)])
    xyz0 = (vt[f[binding]].mean(1) + rng.randn(len(binding), 3) * 0.002).astype(np.float32)
    rot0 = rng.randn(len(binding), 4).astype(np.float32)
    args = SimpleNamespace(subject_out="unused", sequence="seq")
    jscene = JS.Scene(args, None)
    tscene = TS.Scene(args, SimpleNamespace(device=CPU))
    for s in (jscene, tscene):
        s.post_each_frame(True, xyz0, rot0, vt, f, binding, num_knn=8)
        s.post_each_frame(False, xyz0 * 1.01, rot0, vt, f, binding, num_knn=8)
    xyz = (xyz0 + rng.randn(*xyz0.shape) * 0.003).astype(np.float32)
    rot = (rot0 + rng.randn(*rot0.shape) * 0.1).astype(np.float32)
    mesh_v = (vt + rng.randn(*vt.shape) * 0.003).astype(np.float32)
    return jscene.arap_cache(), tscene.arap_cache(), xyz, rot, mesh_v, f, binding


def test_arap_cache_matches_jax(arap_case):
    jc, tc = arap_case[:2]
    for name in JMG.ArapCache._fields:
        got, want = getattr(tc, name), np.asarray(getattr(jc, name))
        assert got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _arap_terms(mod, cache, mesh_f, binding, term):
    if term == "gg":
        return lambda xyz, rot, mesh_v: mod.gg_arap_loss(cache, xyz, rot)
    if term == "gv":
        return lambda xyz, rot, mesh_v: mod.gv_arap_loss(cache, xyz, rot, mesh_v, mesh_f, binding)
    key = term.split("_")[1]
    return lambda xyz, rot, mesh_v: mod.dynamic_3d_loss(cache, xyz, rot, 0.7)[key]


@pytest.mark.parametrize("term", ["gg", "gv", "dynamic_rigid", "dynamic_rot"])
def test_arap_terms_and_gradients_match_jax(arap_case, term):
    jc, tc, xyz, rot, mesh_v, f, binding = arap_case
    jfn = _arap_terms(JMG, jc, jnp.asarray(f), jnp.asarray(binding), term)
    tfn = _arap_terms(TMG, tc, T(f), T(binding), term)
    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(mesh_v))
    targs = [T(a.copy()).requires_grad_(True) for a in (xyz, rot, mesh_v)]
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, targs, allow_unused=True)
    assert float(jval) > 0
    close(tval, jval)
    for name, tg, jg in zip(("xyz", "rot", "mesh_v"), tgrads, jgrads):
        close(torch.zeros(jg.shape) if tg is None else tg, jg, err_msg=name)


# ---------------------------------------------------------------------------
# plain-model covariance, LR schedules, statistics, densify_and_prune
# ---------------------------------------------------------------------------

def _param_arrays(rng, n, r=3):
    return {"xyz": rng.randn(n, 3) * 0.3, "features_dc": rng.randn(n, 1, 3),
            "features_rest": rng.randn(n, r, 3), "scaling": rng.randn(n, 3) * 1.5 - 3.5,
            "rotation": rng.randn(n, 4), "opacity": rng.randn(n, 1) * 3.0}


def _both_params(arrays):
    a = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    return (JG.GaussianParams(**{k: jnp.asarray(v) for k, v in a.items()}),
            TG.GaussianParams(**{k: T(v.copy()) for k, v in a.items()}))


@pytest.mark.parametrize("modifier", [1.0, 0.5])
def test_get_covariance_matches_jax(rng, modifier):
    jp, tp = _both_params(_param_arrays(rng, 40))
    close(TG.get_covariance(tp, modifier), JG.get_covariance(jp, modifier), atol=1e-12)


def test_make_lr_schedules_matches_jax():
    opt = SimpleNamespace(position_lr_init=0.00016, position_lr_final=0.0000016,
                          position_lr_delay_mult=0.01, position_lr_max_steps=30_000,
                          feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
                          rotation_lr=0.001)
    jl, tl = JG.make_lr_schedules(opt, 2.7), TG.make_lr_schedules(opt, 2.7)
    for it in (0, 1, 500, 7000, 29_999, 30_000, 40_000):
        got, want = tl(it), jl(it)
        assert sorted(got) == sorted(want) == sorted(TG.PARAM_NAMES)
        np.testing.assert_allclose(got["xyz"], np.float32(want["xyz"]), rtol=1e-6, atol=0)
        for k in TG.PARAM_NAMES[1:]:
            assert got[k] == want[k], (it, k)


def test_add_densification_stats_matches_jax(rng):
    n = 64
    aux = {"alive": rng.rand(n) > 0.1, "max_radii2d": rng.rand(n).astype(np.float32) * 5,
           "xyz_gradient_accum": rng.rand(n, 1).astype(np.float32),
           "denom": rng.randint(0, 5, (n, 1)).astype(np.float32)}
    ja = JG.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    ta = TG.GaussianAux(**{k: T(v.copy()) for k, v in aux.items()})
    for _ in range(3):
        grad = rng.randn(n, 3).astype(np.float32) * 1e-3
        radii = rng.randint(-1, 9, n).astype(np.int32)
        ja = JG.add_densification_stats(ja, jnp.asarray(grad), jnp.asarray(radii))
        ta = TG.add_densification_stats(ta, T(grad), T(radii))
    for k in TG.AUX_NAMES:
        np.testing.assert_array_equal(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)),
                                      err_msg=k)


@pytest.mark.parametrize("max_screen_size", [None, 20])
def test_densify_and_prune_same_random_state(max_screen_size):
    rng = np.random.RandomState(3)
    n, cap = 120, 130
    arrays = {k: TG._pad_param(k, np.asarray(a, np.float32), cap)
              for k, a in _param_arrays(rng, n).items()}
    alive = np.zeros(cap, bool)
    alive[:n] = True
    stats = {"max_radii2d": rng.rand(cap).astype(np.float32) * 30,
             "xyz_gradient_accum": rng.rand(cap, 1).astype(np.float32) * 4e-3,
             "denom": rng.randint(1, 10, (cap, 1)).astype(np.float32)}
    mu = {k: rng.randn(*a.shape).astype(np.float32) for k, a in arrays.items()}
    nu = {k: rng.rand(*a.shape).astype(np.float32) for k, a in arrays.items()}
    jp, tp = _both_params(arrays)
    j_adam = JG.AdamState(step=jnp.int32(7), mu=_both_params(mu)[0], nu=_both_params(nu)[0])
    t_adam = TG.AdamState(step=7, mu=_both_params(mu)[1], nu=_both_params(nu)[1])
    j_aux = JG.GaussianAux(alive=jnp.asarray(alive),
                           **{k: jnp.asarray(a) for k, a in stats.items()})
    t_aux = TG.GaussianAux(alive=T(alive), **{k: T(a.copy()) for k, a in stats.items()})
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=2.0, max_screen_size=max_screen_size,
              percent_dense=0.01)
    jr = JG.densify_and_prune(jp, j_aux, j_adam, rng=np.random.RandomState(0), **kw)
    tr = TG.densify_and_prune(tp, t_aux, t_adam, rng=np.random.RandomState(0), **kw)
    assert tr[3] == jr[3] and jr[3]["n_clone"] > 0 and jr[3]["n_split"] > 0 \
        and jr[3]["n_prune"] > 0
    for k in TG.AUX_NAMES:
        close(getattr(tr[1], k), getattr(jr[1], k), rtol=0, atol=1e-6, err_msg=k)
    for k in TG.PARAM_NAMES:
        close(getattr(tr[0], k), getattr(jr[0], k), rtol=0, atol=1e-6, err_msg=k)
        close(getattr(tr[2].mu, k), getattr(jr[2].mu, k), rtol=0, atol=1e-6, err_msg=k)
        close(getattr(tr[2].nu, k), getattr(jr[2].nu, k), rtol=0, atol=1e-6, err_msg=k)
    assert tr[2].step == int(jr[2].step)
