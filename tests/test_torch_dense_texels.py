"""The dense texel layout (``--dense_texels``) in the port, against the JAX
package's dense layout and the port's own compact layout, on the CPU, on
``tests/torch_s3_case.py``'s sheet with its UVs inset so that a third of the
texels are dead. Mirrors ``tests/test_s3.py::TestDenseLayout``.

Tolerances: integer fields, alive masks and textures exact; barycentrics
rtol 1e-5 / atol 1e-6 against JAX (the same float32 formulas); the bakes as
in ``tests/test_torch_avatar_net.py``. Dense against compact in the port:
the same float32 operations on the same rows, so the eval render and the
per-tile pair counts are equal bit for bit, and one step's losses agree to
1e-4·|loss| + 1e-6 (the hinges sum over res² rows in place of G); the JAX
dense step is held to the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.data.baker import bake_textures as j_bake
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models.adam import tree_adam_init
from gaussian_garments_tpu.training import checkpoints as jckpt
from gaussian_garments_tpu.training import s3 as JS3
from gaussian_garments_tpu.utils import losses as JL
from gaussian_garments_tpu_torch.data.baker import bake_textures as t_bake
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet as TAvatarNet
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.renderer import _project
from gaussian_garments_tpu_torch.training import checkpoints as tckpt
from gaussian_garments_tpu_torch.training import s3 as TS3
from torch_s3_case import (CFG, DEG, HW, RES, build_case, jax_item, port_item, run_s3,
                           s3_args, write_s3_layout)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    c = build_case(seed=7)
    kw = dict(bind_map=c["bind_map"], device="cpu")
    c["tbind"] = TAG.build_binding(c["uvs"], c["faces"], RES, **kw)[0]
    c["tdense"] = TAG.build_binding(c["uvs"], c["faces"], RES, dense=True, **kw)[0]
    c["jdense"] = JAG.build_binding(c["uvs"], c["faces"], RES, bind_map=c["bind_map"],
                                    dense=True)[0]
    return c


def _params(n, rng):
    return {"xyz": rng.randn(n, 3), "features_dc": rng.randn(n, 1, 3),
            "features_rest": rng.randn(n, 3, 3), "scaling": rng.randn(n, 3),
            "rotation": rng.randn(n, 4), "opacity": rng.randn(n, 1)}


def test_structure(case):
    tc, td, jd = case["tbind"], case["tdense"], case["jdense"]
    alive = td.alive.numpy()
    assert td.dense and td.binding.shape[0] == RES * RES
    assert 0.5 < alive.mean() < 0.8                     # a real share of dead texels
    assert alive.sum() == tc.binding.shape[0]
    np.testing.assert_array_equal(td.binding.numpy()[alive], tc.binding.numpy())
    np.testing.assert_array_equal(td.gs_bc.numpy()[alive], tc.gs_bc.numpy())
    np.testing.assert_array_equal(np.where(alive)[0], tc.flat_idx.numpy())
    np.testing.assert_array_equal(td.gs_bc.numpy()[~alive], np.tile([1.0, 0, 0], (
        (~alive).sum(), 1)))
    np.testing.assert_array_equal(alive, np.asarray(jd.alive))
    for f in ("binding", "flat_idx", "gs_u", "gs_v"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), f)
    np.testing.assert_allclose(td.gs_bc.numpy(), np.asarray(jd.gs_bc), rtol=1e-5, atol=1e-6)


def test_gather_scatter(case, rng):
    tc, td, jd = case["tbind"], case["tdense"], case["jdense"]
    alive = td.alive.numpy()
    tex = rng.randn(5, RES, RES).astype(np.float32)
    got = TAG.gather_texture(td, torch.from_numpy(tex)).numpy()
    np.testing.assert_array_equal(got[alive], TAG.gather_texture(tc, torch.from_numpy(tex)))
    np.testing.assert_array_equal(got, np.asarray(JAG.gather_texture(jd, jnp.asarray(tex))))
    # dense rows, garbage at dead texels → the compact layout's texture
    vals = rng.randn(RES * RES, 5).astype(np.float32)
    got = TAG.scatter_texture(td, torch.from_numpy(vals), 5).numpy()
    np.testing.assert_array_equal(got, TAG.scatter_texture(tc, torch.from_numpy(vals[alive]), 5))
    np.testing.assert_array_equal(got, np.asarray(JAG.scatter_texture(jd, jnp.asarray(vals), 5)))


def test_baker(case):
    verts, faces = case["verts"], case["faces"]
    occ = [(verts + np.array([0.0, 0.0, 0.15], np.float32), faces)]
    ad, nd = t_bake(case["tdense"], verts, faces, occluders=occ, n_samples=8)
    ac, nc = t_bake(case["tbind"], verts, faces, occluders=occ, n_samples=8)
    np.testing.assert_array_equal(ad, ac)
    np.testing.assert_array_equal(nd, nc)
    ja, jn = j_bake(case["jdense"], verts, faces, occluders=occ, n_samples=8)
    assert 0.0 < ad[0][case["tdense"].alive.numpy().reshape(RES, RES)].mean() < 1.0
    np.testing.assert_allclose(ad, np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nd, np.asarray(jn), rtol=0, atol=1e-6)


def test_checkpoint_layout_round_trip(case, rng, tmp_path):
    tc, td, jd = case["tbind"], case["tdense"], case["jdense"]
    alive = td.alive.numpy()
    p = {k: v.astype(np.float32) for k, v in _params(tc.binding.shape[0], rng).items()}
    compact = TG.GaussianParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    dense = TAG.densify_params(td, compact)
    jdense = JAG.densify_params(jd, JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}))
    for k in TG.PARAM_NAMES:
        np.testing.assert_array_equal(getattr(dense, k).numpy(), np.asarray(getattr(jdense, k)))
        np.testing.assert_array_equal(getattr(TAG.adapt_params_layout(tc, dense), k), p[k])
        np.testing.assert_array_equal(getattr(TAG.adapt_params_layout(td, compact), k),
                                      getattr(dense, k))
    assert (dense.rotation.numpy()[~alive] == [1.0, 0, 0, 0]).all()
    # the texture checkpoint is the same for both layouts and both packages
    maps_c, maps_d = TAG.gaussian_maps(tc, compact), TAG.gaussian_maps(td, dense)
    maps_j = JAG.gaussian_maps(jd, jdense)
    assert maps_c.keys() == maps_d.keys() == maps_j.keys()
    for k in maps_c:
        np.testing.assert_array_equal(maps_d[k], maps_c[k], err_msg=k)
        np.testing.assert_array_equal(maps_d[k], maps_j[k], err_msg=k)
    loaded = TAG.load_gaussian_maps(maps_c, bind=td)
    jloaded = JAG.load_gaussian_maps(maps_c, bind=jd)
    back = TAG.load_gaussian_maps(maps_d, device="cpu")
    for k in TG.PARAM_NAMES:
        np.testing.assert_array_equal(getattr(loaded, k).numpy(), np.asarray(getattr(jloaded, k)))
        np.testing.assert_array_equal(getattr(back, k), p[k])
    # a dense checkpoint of the port loads into the JAX compact layout, and a
    # compact JAX checkpoint into the port's dense one
    tckpt.save_s3_ckpt(tmp_path / "port", epoch=1, active_sh_degree=DEG, splats=dense,
                       net_params={}, net_buffers={})
    got = JAG.adapt_params_layout(case["jbind"], jckpt.load_s3_ckpt(tmp_path / "port")["splats"])
    for k in TG.PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), p[k])
    jstate = jax.tree.map(np.asarray, case["jstate"])
    jckpt.save_s3_ckpt(tmp_path / "jax", jstate, 1, active_sh_degree=DEG)
    got = TAG.adapt_params_layout(td, tckpt.load_s3_ckpt(tmp_path / "jax")["splats"].to("cpu"))
    for k in TG.PARAM_NAMES:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(),
            np.asarray(getattr(JAG.adapt_params_layout(jd, jstate.splats), k)))


@pytest.fixture(scope="module")
def states(case):
    """The case's state in the port's compact and dense layouts, and the
    dense item (its visibility from the port's depth test on the dense
    binding, which must equal the compact one at alive texels)."""
    td = case["tdense"]
    compact = tckpt.s3_state_from_jax(jax.tree.map(np.asarray, case["jstate"]), device="cpu")
    dense = compact.replace(splats=TAG.densify_params(td, compact.splats))
    dense = dense.replace(splat_adam=TG.adam_init(dense.splats))
    item = case["item"]
    vis = np.stack([TAG.get_visible_mask_depth(
        td, torch.from_numpy(item["mesh_v"][b]), case["tf"],
        torch.from_numpy(item["world_view"][b]), torch.from_numpy(item["full_proj"][b]),
        image_width=HW, image_height=HW).numpy() for b in range(2)]).astype(np.float32)
    np.testing.assert_array_equal(vis[:, td.alive.numpy()], item["vis"])
    return compact, dense, vis


def test_render_equals_compact(case, states):
    """The eval render of the dense layout is the compact one bit for bit,
    and every tile holds the same number of pairs: dead texels (opacity 0)
    yield none."""
    compact, dense, vis = states
    net = TAvatarNet(RES, DEG)
    ev = TS3.make_s3_eval(net, sh_degree=DEG, vis_raster_hw=(HW, HW))
    img_c = ev(compact, case["tbind"], case["tf"], port_item(case["item"]))
    img_d = ev(dense, case["tdense"], case["tf"], port_item(case["item"], vis))
    assert float(img_c.std()) > 0.05
    assert torch.equal(img_d, img_c)
    counts = []
    for bind, state, item in ((case["tbind"], compact, port_item(case["item"])),
                              (case["tdense"], dense, port_item(case["item"], vis))):
        with torch.no_grad():
            bundle, v, _ = TS3._s3_project(net, (state.net_params, state.net_buffers),
                                           state.splats, bind, case["tf"], item, 0,
                                           sh_degree=DEG)
            proj = _project(bundle, item.world_view[0], item.full_proj[0], item.campos[0],
                            width=HW, height=HW, tanfovx=item.tanfovx[0],
                            tanfovy=item.tanfovy[0], scaling_modifier=1.0, vis_mask=v,
                            screen_offset=None)
            pairs = tiles.bin_pairs(proj, image_width=HW, image_height=HW)
        counts.append(pairs.ranges[1:] - pairs.ranges[:-1])
    assert int(counts[0].sum()) > 0
    assert torch.equal(counts[1], counts[0])


def test_step_equals_compact(case, states):
    compact, dense, vis = states
    kw = dict(sh_degree=DEG, vis_raster_hw=(HW, HW))
    step = TS3.make_s3_step(TAvatarNet(RES, DEG), s3_args(), **kw)
    _, lc = step(compact, case["tbind"], case["tf"], port_item(case["item"]))
    _, ld = step(dense, case["tdense"], case["tf"], port_item(case["item"], vis))
    jdense = case["jstate"].replace(splats=JAG.densify_params(case["jdense"],
                                                              case["jstate"].splats))
    jdense = jdense.replace(splat_adam=tree_adam_init(jdense.splats))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS3, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))
        jstep = JS3.make_s3_step(case["jnet"], s3_args(), raster_cfg=CFG, **kw)
        _, lj = jstep(jdense, case["jdense"], case["jf"], jax_item(case["item"], vis))
    for want in (lc, lj):
        assert sorted(ld) == sorted(want)
        for k in want:
            a, b = float(want[k]), float(ld[k])
            assert abs(a - b) <= 1e-4 * abs(a) + 1e-6, (k, a, b)


def test_cli_drive_dense_texels(tmp_path, monkeypatch, capsys):
    """``s3_appearance --dense_texels`` from its entry point writes res²
    splat rows; the compact run resumes from that checkpoint, and the dense
    run from a compact one."""
    roots = write_s3_layout(tmp_path)
    stats = run_s3(["--dense_texels"], roots, monkeypatch)
    assert stats["n_texels"] == RES * RES
    assert stats["steps"]["pre"]["n"] + stats["steps"]["full"]["n"] == 20
    assert all(np.isfinite([e["img"] for e in stats["losses"]]))
    stage3 = roots["out"] / "subj" / "stage3"
    ck = tckpt.load_s3_ckpt(stage3)
    assert ck["epoch"] == 5 and ck["splats"].xyz.shape == (RES * RES, 3)
    capsys.readouterr()
    assert run_s3([], roots, monkeypatch)["n_texels"] < RES * RES
    assert "Resumed from epoch 5" in capsys.readouterr().out
    bind = TAG.build_binding(roots["uvs"], roots["faces"], RES, device="cpu")[0]
    compact = TAG.adapt_params_layout(bind, ck["splats"].to("cpu"))
    tckpt.save_s3_ckpt(tmp_path / "compact", epoch=5, active_sh_degree=DEG, splats=compact,
                       net_params=ck["net_params"], net_buffers=ck["net_buffers"])
    run_s3(["--dense_texels", "--ckpt_path", str(tmp_path / "compact")], roots, monkeypatch)
    assert "Resumed from epoch 5" in capsys.readouterr().out
