"""PyTorch port against the JAX package: UV binding, texture bake, the
StyleUNet's resampling, AvatarNet with weights carried over from a Flax init,
and stage-3 checkpoints in both directions, on the CPU.

Tolerances: integer maps exact; per-texel geometry rtol 1e-5 / atol 1e-6 (the
same float32 formulas); AvatarNet output atol 1e-4: some 25 convolutions of
the 64² UNet sum in a different order in XLA and in PyTorch (both full
float32), and the output is O(1).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.data.baker import bake_textures as j_bake
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.models import styleunet as JSU
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet
from gaussian_garments_tpu.training import checkpoints as jckpt
from gaussian_garments_tpu_torch.data.baker import bake_textures as t_bake
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG
from gaussian_garments_tpu_torch.models import styleunet as TSU
from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet as TAvatarNet
from gaussian_garments_tpu_torch.training import checkpoints as tckpt

RES, DEG = 64, 1
T = torch.from_numpy


@pytest.fixture(scope="module")
def garment():
    verts, faces, uvs = jsyn.make_cloth_template(7, 6)
    verts = verts + np.random.RandomState(3).randn(*verts.shape).astype(np.float32) * 0.02
    jbind, jmap = JAG.build_binding(uvs, faces, RES)
    tbind, tmap = TAG.build_binding(uvs, faces, RES, device="cpu")
    return verts, faces, uvs, jbind, jmap, tbind, tmap


def test_bind_map_and_binding_match_jax(garment):
    verts, faces, uvs, jbind, jmap, tbind, tmap = garment
    np.testing.assert_array_equal(tmap, np.asarray(jmap))
    assert (tmap > -1).mean() > 0.5
    for f in ("binding", "flat_idx", "gs_u", "gs_v"):
        np.testing.assert_array_equal(getattr(tbind, f).numpy(), np.asarray(getattr(jbind, f)))
    np.testing.assert_allclose(tbind.gs_bc.numpy(), np.asarray(jbind.gs_bc), rtol=1e-5, atol=1e-6)


def test_texel_geometry_matches_jax(garment, rng):
    """Anchors, world positions, rotations and scales of the texel splats."""
    verts, faces, uvs, jbind, jmap, tbind, tmap = garment
    n = tbind.binding.shape[0]
    p = dict(xyz=rng.randn(n, 3) * 0.01, features_dc=rng.randn(n, 1, 3),
             features_rest=rng.randn(n, 3, 3), scaling=rng.randn(n, 3) - 4,
             rotation=rng.randn(n, 4), opacity=rng.randn(n, 1))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = TG.GaussianParams(**{k: T(v) for k, v in p.items()})
    jv, jf = jnp.asarray(verts), jnp.asarray(faces.astype(np.int32))
    tv, tf = T(verts), T(faces)
    jfr, tfr = JMG.compute_face_frames(jv, jf), TMG.compute_face_frames(tv, tf)
    jrows = JMG.gather_frame_rows(jfr, jbind.binding, jv, jf)
    trows = TMG.gather_frame_rows(tfr, tbind.binding, tv, tf)
    ja, ta = JAG.barycentric_3d(jbind, jv, jf, rows=jrows), TAG.barycentric_3d(tbind, tv, tf, rows=trows)
    pairs = [
        (ta, ja),
        (TAG.avatar_world_xyz(tp.xyz, tbind, tfr, ta, rows=trows),
         JAG.avatar_world_xyz(jp.xyz, jbind, jfr, ja, rows=jrows)),
        (TMG.world_rotation(tp, tbind.binding, tfr, rows=trows),
         JMG.world_rotation(jp, jbind.binding, jfr, rows=jrows)),
        (TMG.world_scaling(tp, tbind.binding, tfr, rows=trows),
         JMG.world_scaling(jp, jbind.binding, jfr, rows=jrows)),
        (TG.get_opacity(tp), JG.get_opacity(jp)),
        (TG.get_scaling(tp), JG.get_scaling(jp)),
        (TG.get_rotation(tp), JG.get_rotation(jp)),
        (TG.get_features(tp), JG.get_features(jp)),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=str(i))
    tex = rng.randn(5, RES, RES).astype(np.float32)
    np.testing.assert_array_equal(TAG.gather_texture(tbind, T(tex)).numpy(),
                                  np.asarray(JAG.gather_texture(jbind, jnp.asarray(tex))))


def test_bake_textures_matches_jax(garment):
    """Same normals, same hemisphere directions, same BVH: the AO fractions
    are equal and the normals agree to float32 rounding."""
    verts, faces, uvs, jbind, jmap, tbind, tmap = garment
    occ = (verts + np.array([0.0, 0.0, 0.15], np.float32), faces)
    ja, jn = j_bake(jbind, verts, faces, occluders=[occ], n_samples=16)
    ta, tn = t_bake(tbind, verts, faces, occluders=[occ], n_samples=16)
    assert 0.0 < ta[tmap[None] > -1].mean() < 1.0
    np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tn, np.asarray(jn), rtol=0, atol=1e-6)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 1, (1, 0, 1, 0))])
def test_upfirdn2d_matches_jax(rng, up, down, pad):
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    k = TSU.make_kernel((1, 3, 3, 1)) if len(pad) == 2 else TSU._haar_kernels()[1]
    np.testing.assert_allclose(TSU.upfirdn2d(T(x), k, up=up, down=down, pad=pad).numpy(),
                               np.asarray(JSU.upfirdn2d(jnp.asarray(x), k, up=up, down=down,
                                                        pad=pad)), rtol=0, atol=1e-6)


def test_haar_transforms_match_jax(rng):
    x = rng.randn(1, 8, 10, 10).astype(np.float32)
    np.testing.assert_allclose(TSU.haar_transform(T(x)).numpy(),
                               np.asarray(JSU.haar_transform(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(TSU.inverse_haar_transform(T(x)).numpy(),
                               np.asarray(JSU.inverse_haar_transform(jnp.asarray(x))), atol=1e-6)


@pytest.fixture(scope="module")
def net_case(garment):
    """A Flax AvatarNet initialised from a seed, its inputs, and its output."""
    verts, faces, uvs, jbind, jmap, tbind, tmap = garment
    rng = np.random.RandomState(1)
    ambient = rng.rand(1, RES, RES).astype(np.float32)
    normal = (rng.rand(3, RES, RES).astype(np.float32) * (tmap > -1)[None]).astype(np.float32)
    cam = jsyn.make_camera_ring(1, radius=0.5, height=2.0, width=64, height_px=64)[0]
    jv, jf = jnp.asarray(verts), jnp.asarray(faces.astype(np.int32))
    frames = JMG.compute_face_frames(jv, jf)
    net = JAvatarNet(texture_size=RES, sh_degree=DEG)
    args = (jnp.asarray(ambient), jnp.asarray(normal), cam.world_view_transform,
            cam.camera_center, jbind, jv, jf, frames)
    variables = net.init(jax.random.PRNGKey(0), *args)
    out = net.apply(variables, *args)
    params = jax.tree.map(np.asarray, variables["params"])
    buffers = jax.tree.map(np.asarray, variables["buffers"])
    return dict(ambient=ambient, normal=normal, cam=cam, params=params, buffers=buffers,
                out=np.asarray(out), verts=verts, faces=faces, tbind=tbind)


def test_avatar_net_matches_flax(net_case):
    c = net_case
    from gaussian_garments_tpu_torch import pin_full_f32

    pin_full_f32()
    net = TAvatarNet(texture_size=RES, sh_degree=DEG)
    net.load_state_dict(tckpt.avatar_net_state_from_jax(c["params"], c["buffers"]))
    net.eval()
    tv, tf = T(c["verts"]), T(c["faces"])
    wv = T(np.asarray(c["cam"].world_view_transform))
    cc = T(np.asarray(c["cam"].camera_center))
    with torch.no_grad():
        out = net(T(c["ambient"]), T(c["normal"]), wv, cc, c["tbind"], tv, tf,
                  TMG.compute_face_frames(tv, tf))
    assert out.shape == c["out"].shape == ((DEG + 1) ** 2 * 3 + 3, RES, RES)
    assert np.abs(c["out"]).max() > 0.1
    np.testing.assert_allclose(out.numpy(), c["out"], rtol=0, atol=1e-4)


def test_state_dict_converter_round_trip(net_case):
    """Flax trees -> state_dict -> Flax trees is the identity, and every
    parameter and buffer of the port's module is named by the Flax tree."""
    c = net_case
    state = tckpt.avatar_net_state_from_jax(c["params"], c["buffers"])
    net = TAvatarNet(texture_size=RES, sh_degree=DEG)
    assert set(state) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    params, buffers = tckpt.avatar_net_state_to_jax(state)
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    for got, want in ((params, c["params"]), (buffers, c["buffers"])):
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _splats(n, rng):
    return dict(xyz=rng.randn(n, 3), features_dc=rng.randn(n, 1, 3),
                features_rest=rng.randn(n, 3, 3), scaling=rng.randn(n, 3),
                rotation=rng.randn(n, 4), opacity=rng.randn(n, 1))


def test_reads_checkpoint_written_by_jax(net_case, tmp_path, rng):
    """A ``net.pkl`` saved by the JAX trainer loads without jax: its pickled
    ``GaussianParams`` becomes the port's container."""
    c = net_case
    sp = {k: v.astype(np.float32) for k, v in _splats(10, rng).items()}
    state = types.SimpleNamespace(net_params=c["params"], net_buffers=c["buffers"],
                                  splats=JG.GaussianParams(**{k: jnp.asarray(v)
                                                              for k, v in sp.items()}))
    jckpt.save_s3_ckpt(tmp_path, state, epoch=3, active_sh_degree=DEG, save_optm=False)
    ck = tckpt.load_s3_ckpt(tmp_path)
    assert isinstance(ck["splats"], TG.GaussianParams)
    for k, v in sp.items():
        np.testing.assert_array_equal(np.asarray(getattr(ck["splats"], k)), v)
    assert ck["epoch"] == 3 and ck["activate_sh_degree"] == DEG
    net = TAvatarNet(texture_size=RES, sh_degree=DEG)
    net.load_state_dict(tckpt.avatar_net_state_from_jax(ck["net_params"], ck["net_buffers"]))


def test_jax_reads_checkpoint_written_by_port(net_case, tmp_path, rng):
    c = net_case
    sp = {k: v.astype(np.float32) for k, v in _splats(7, rng).items()}
    tckpt.save_s3_ckpt(tmp_path, net_params=c["params"], net_buffers=c["buffers"],
                       splats=TG.GaussianParams(**{k: T(v) for k, v in sp.items()}),
                       epoch=1, active_sh_degree=DEG)
    ck = jckpt.load_s3_ckpt(tmp_path)
    assert isinstance(ck["splats"], JG.GaussianParams)
    for k, v in sp.items():
        np.testing.assert_array_equal(np.asarray(getattr(ck["splats"], k)), v)
    leaves = jax.tree_util.tree_leaves(ck["net_params"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(c["params"]))


def test_orbax_checkpoint_raises(tmp_path):
    """A committed orbax checkpoint (a manager step directory) is refused by
    name; an empty ``net.orbax`` left by a writer killed before its first
    commit is no checkpoint at all."""
    (tmp_path / "ckpt" / "net.orbax").mkdir(parents=True)
    assert not tckpt.has_s3_ckpt(tmp_path)
    (tmp_path / "ckpt" / "net.orbax" / "4").mkdir()
    assert tckpt.has_s3_ckpt(tmp_path)
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_s3_ckpt(tmp_path)
