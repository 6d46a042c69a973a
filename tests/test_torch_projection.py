"""PyTorch port against the JAX package: SH, quaternions, cameras, geometry,
face frames and the EWA projection, on the CPU.

Inputs are made with numpy from a seed and go through both functions. Both
sides compute in float32 with the same formulas in the same order, so the
tolerances are a few float32 ulps: rtol 1e-5 (atol 1e-6 where a value can
pass through zero, where a relative bound means nothing).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu import geometry as jgeo
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.ops import projection as JP
from gaussian_garments_tpu.utils import camera as JC
from gaussian_garments_tpu.utils import quaternion as JQ
from gaussian_garments_tpu.utils import sh as JSH
from gaussian_garments_tpu_torch import geometry as tgeo
from gaussian_garments_tpu_torch.data import synthetic as tsyn
from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG
from gaussian_garments_tpu_torch.ops import projection as TP
from gaussian_garments_tpu_torch.utils import camera as TC
from gaussian_garments_tpu_torch.utils import quaternion as TQ
from gaussian_garments_tpu_torch.utils import sh as TSH

RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol, **kw)


def close_rows(t, j):
    """For rows whose entries share a scale but may pass through zero (a
    covariance, a conic): error relative to each row's largest entry."""
    t, j = t.detach().numpy(), np.asarray(j)
    scale = np.abs(j).max(axis=1, keepdims=True)
    np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=RTOL)


T = torch.from_numpy


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(rng, deg):
    k = (deg + 1) ** 2
    sh = rng.randn(200, 3, k).astype(np.float32)
    dirs = rng.randn(200, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    close(TSH.eval_sh(deg, T(sh), T(dirs)), JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))


def test_rgb2sh(rng):
    rgb = rng.rand(50, 3).astype(np.float32)
    close(TSH.rgb2sh(T(rgb)), JSH.rgb2sh(jnp.asarray(rgb)))


def test_quaternions(rng):
    q = rng.randn(64, 4).astype(np.float32)
    close(TQ.normalize(T(q)), JQ.normalize(jnp.asarray(q)))
    m = TQ.quat_to_rotmat(TQ.normalize(T(q)))
    close(m, JQ.quat_to_rotmat(JQ.normalize(jnp.asarray(q))))
    # rotmat -> quat is sign-ambiguous; both pick the same branch
    close(TQ.rotmat_to_quat(m), JQ.rotmat_to_quat(jnp.asarray(m.numpy())))
    b = rng.randn(64, 4).astype(np.float32)
    close(TQ.quat_multiply(T(q), T(b)), JQ.quat_multiply(jnp.asarray(q), jnp.asarray(b)))


def test_build_cov3d(rng):
    s = np.exp(rng.randn(100, 3).astype(np.float32) - 3)
    q = rng.randn(100, 4).astype(np.float32)
    close_rows(TP.build_cov3d(T(s), T(q), 1.3),
               JP.build_cov3d(jnp.asarray(s), jnp.asarray(q), 1.3))


@pytest.mark.parametrize("json_cam", [False, True])
def test_camera_matrices(json_cam):
    if json_cam:
        params = {"intrinsics": [[900.0, 0, 470], [0, 910.0, 640], [0, 0, 1]],
                  "extrinsics": [[0.96, 0.0, 0.28, 0.1], [0.0, 1.0, 0.0, -0.2],
                                 [-0.28, 0.0, 0.96, 2.5]]}
        tc = TC.camera_from_json_params(params, h=1280, w=940, device="cpu")
        jc = JC.camera_from_json_params(params, h=1280, w=940)
    else:
        kw = dict(R=np.eye(3), T=np.array([0.1, -0.2, 3.0]), fx=150, fy=160, cx=33, cy=30,
                  width=64, height=60)
        tc, jc = TC.make_camera(**kw, device="cpu"), JC.make_camera(**kw)
    for f in ("world_view_transform", "full_proj_transform", "camera_center"):
        close(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert tc.tanfovx == pytest.approx(jc.tanfovx, rel=1e-12)
    assert tc.tanfovy == pytest.approx(jc.tanfovy, rel=1e-12)
    assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)


def test_camera_ring_matches_jax():
    from gaussian_garments_tpu.data import synthetic as jsyn

    tcs = tsyn.make_camera_ring(3, radius=0.4, height=2.2, width=64, height_px=64,
                               device="cpu")
    jcs = jsyn.make_camera_ring(3, radius=0.4, height=2.2, width=64, height_px=64)
    for tc, jc in zip(tcs, jcs):
        close(tc.full_proj_transform, jc.full_proj_transform)
        close(tc.camera_center, jc.camera_center)


def test_cloth_template_matches_jax():
    from gaussian_garments_tpu.data import synthetic as jsyn

    for a, b in zip(tsyn.make_cloth_template(7, 5), jsyn.make_cloth_template(7, 5)):
        np.testing.assert_array_equal(a, b)


def test_geometry_and_face_frames(rng):
    verts, faces, _ = tsyn.make_cloth_template(6, 5)
    verts = verts + rng.randn(*verts.shape).astype(np.float32) * 0.01
    tv, tf = T(verts), T(faces)
    jv, jf = jnp.asarray(verts), jnp.asarray(faces.astype(np.int32))
    close(tgeo.face_normals(tv, tf), jgeo.face_normals(jv, jf))
    close(tgeo.gather_triangles(tv, tf), jgeo.gather_triangles(jv, jf))
    tri = rng.rand(40, 3, 2).astype(np.float32) * 10
    pts = rng.rand(40, 2).astype(np.float32) * 10
    for a, b in zip(tgeo.barycentric_2d(T(tri), T(pts)),
                    jgeo.barycentric_2d(jnp.asarray(tri), jnp.asarray(pts))):
        close(a, b, atol=1e-5)
    tfr, jfr = TMG.compute_face_frames(tv, tf), JMG.compute_face_frames(jv, jf)
    for f in ("center", "orien_mat", "orien_quat", "scaling"):
        close(getattr(tfr, f), getattr(jfr, f), err_msg=f)
    binding = rng.randint(0, faces.shape[0], 30)
    close(TMG.gather_frame_rows(tfr, T(binding), tv, tf),
          JMG.gather_frame_rows(jfr, jnp.asarray(binding), jv, jf))


def _scene(rng, n=300, deg=3):
    means = rng.randn(n, 3).astype(np.float32) * 0.4
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.4 - 3.2)
    rots = rng.randn(n, 4).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.randn(n)))).astype(np.float32)
    shs = rng.randn(n, (deg + 1) ** 2, 3).astype(np.float32) * 0.3
    return means, scales, rots, opac, shs


@pytest.mark.parametrize("deg", [0, 3])
def test_project_gaussians(rng, deg):
    """means2d, conic, depth, rgb and opacity at rtol 1e-5; radii exact. The
    camera sits close enough that some splats fall behind the near plane or
    outside the frustum, so culling is exercised too."""
    means, scales, rots, opac, shs = _scene(rng, deg=deg)
    kw = dict(R=np.eye(3), T=np.array([0.05, -0.1, 1.2]), fx=120, fy=125, cx=35, cy=30,
              width=72, height=60)
    tc, jc = TC.make_camera(**kw, device="cpu"), JC.make_camera(**kw)
    common = dict(image_width=72, image_height=60, tanfovx=jc.tanfovx, tanfovy=jc.tanfovy,
                  sh_degree=deg)
    jp = JP.project_gaussians(
        jnp.asarray(means), jc.world_view_transform, jc.full_proj_transform, jc.camera_center,
        scales=jnp.asarray(scales), rotations=jnp.asarray(rots), shs=jnp.asarray(shs),
        opacities=jnp.asarray(opac), **common)
    tp = TP.project_gaussians(
        T(means), tc.world_view_transform, tc.full_proj_transform, tc.camera_center,
        scales=T(scales), rotations=T(rots), shs=T(shs), opacities=T(opac), **common)
    radii = np.asarray(jp.radii)
    assert 0 < (radii > 0).sum() < len(radii)
    np.testing.assert_array_equal(tp.radii.numpy(), radii)
    for f in ("means2d", "depth", "rgb", "opacity"):
        close(getattr(tp, f), getattr(jp, f), err_msg=f)
    close_rows(tp.conic, jp.conic)
