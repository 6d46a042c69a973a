"""The stage-2 slice as a whole: the port's ``make_s2_step`` against the JAX
``make_s2_step``, both started from one state (``s2_state_from_jax``) on the
synthetic scene of ``tests/test_s2.py`` (4 cameras, a 10×10 sheet, 64×64),
three steps of each mode, the JAX side on the CPU with its default tiled
backend and ``tests/test_s2.py``'s ``RasterConfig``. Then a CPU drive of the
port's driver on a tiny dataset, and the device default.

The JAX step blurs for SSIM with a 3-pass bf16 matmul (``fast=True``, a TPU
speed trade, ≤3.5e-3 on the SSIM value); the port blurs in full f32. The
parity runs hand the JAX step its own f32 blur (``fast=False``), so the two
differ only by f32 summation order:
- loss terms: rtol 1e-5;
- vertices and splat parameters: 1% of the most that three Adam steps can
  move them (3·lr of their group). Adam divides each gradient by its running
  RMS, so a gradient component that is near zero, and so known only to a
  large relative rounding error, still moves its parameter by up to lr per
  step; measured differences are ~0.2% of lr;
- densification statistics: rtol 1e-4 on the accumulated screen-gradient
  norms (sums of per-pixel float32 terms in another order); the visibility
  counts and radii exactly.
One more run keeps the JAX step's own ``fast=True`` blur and holds the SSIM
term to its stated 3.5e-3·λ_dssim.
"""
import json
import os
import subprocess
import sys
from argparse import ArgumentParser
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.config import OptimizationParams
from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.models import mesh_model as JMM
from gaussian_garments_tpu.renderer import BatchedCameras as JBatch, RasterConfig as JCfg
from gaussian_garments_tpu.training import s2 as JS2
from gaussian_garments_tpu.utils import losses as JL
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.renderer import BatchedCameras as TBatch
from gaussian_garments_tpu_torch.training import s2 as TS2
from gaussian_garments_tpu_torch.training.checkpoints import s2_state_from_jax, s2_state_to_jax
from gaussian_garments_tpu_torch.utils.camera import make_camera

REPO = Path(__file__).resolve().parent.parent
CFG = JCfg(tile_capacity=128, chunk_tiles=16)
LR = 1.6e-3


def _opt():
    parser = ArgumentParser()
    return OptimizationParams(parser).extract(parser.parse_args([]))


@pytest.fixture(scope="module")
def scene():
    cams, verts, faces, uvs, colors = jsyn.make_scene(n_cams=4, nx=10, ny=10, width=64, height=64)
    v0 = verts + np.random.RandomState(0).randn(*verts.shape).astype(np.float32) * 0.01
    params, aux, binding, _ = JMG.create_from_template(v0, faces, colors, max_sh_degree=0)
    # anisotropic scales and turned rotations: with the template's isotropic
    # splats the rotation gradient is exactly zero, and Adam would turn its
    # rounding noise into steps of ±lr
    rng = np.random.RandomState(1)
    params = params.replace(
        scaling=params.scaling + jnp.asarray(rng.randn(*params.scaling.shape) * 0.3, jnp.float32),
        rotation=params.rotation + jnp.asarray(rng.randn(*params.rotation.shape) * 0.3,
                                               jnp.float32))
    body_v = verts - np.array([0, 0, 0.0005], np.float32)
    nn = np.arange(len(verts)) % len(faces)
    mesh = JMM.init_body(JMM.create(v0, faces), body_v, faces, nn)
    jstate = JS2.init_state(params, aux, binding, mesh)
    tcams = [make_camera(R=c.R, T=c.T, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.image_width,
                         height=c.image_height, image=np.asarray(c.original_image),
                         gt_alpha_mask=np.asarray(c.gt_alpha_mask), device="cpu") for c in cams]
    return jstate, JBatch.from_cameras(cams), TBatch.from_cameras(tcams)


def _f32_blur(monkeypatch):
    monkeypatch.setattr(JS2, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))


def _run(scene, mode, use_body, n=3):
    jstate, jbatch, tbatch = scene
    tstate = s2_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = JS2.make_s2_step(_opt(), mode=mode, use_body=use_body, raster_cfg=CFG)
    tstep = TS2.make_s2_step(_opt(), mode=mode, use_body=use_body)
    jl, tl = [], []
    for _ in range(n):
        jstate, jd, jm = jstep(jstate, jbatch, jnp.zeros(3), LR, LR)
        tstate, td, tm = tstep(tstate, tbatch, torch.zeros(3), LR, LR)
        jl.append({k: float(v) for k, v in jd.items()})
        tl.append({k: float(v) for k, v in td.items()})
    return jstate, tstate, jl, tl


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


@pytest.mark.parametrize("mode,use_body", [("template_p1", False), ("template_p2", True),
                                           ("seq", True)])
def test_three_steps_match_jax(scene, monkeypatch, mode, use_body):
    _f32_blur(monkeypatch)
    jstate, tstate, jl, tl = _run(scene, mode, use_body)
    for j, t in zip(jl, tl):
        assert sorted(j) == sorted(t)
        for k in j:
            _close(t[k], j[k], rtol=1e-5, atol=1e-9, err_msg=k)
    got = s2_state_to_jax(tstate)
    opt = _opt()
    lrs = {"xyz": LR, "features_dc": opt.feature_lr, "features_rest": opt.feature_lr / 20,
           "opacity": opt.opacity_lr, "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
    _close(got["mesh"]["v"], jstate.mesh.v, rtol=0, atol=0.01 * 3 * LR)
    for k in TG.PARAM_NAMES:
        _close(got["params"][k], getattr(jstate.params, k), rtol=0, atol=0.01 * 3 * lrs[k],
               err_msg=k)
    _close(got["aux"]["xyz_gradient_accum"], jstate.aux.xyz_gradient_accum, rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(got["aux"]["denom"], np.asarray(jstate.aux.denom))
    np.testing.assert_array_equal(got["aux"]["max_radii2d"], np.asarray(jstate.aux.max_radii2d))
    assert got["iteration"] == int(jstate.iteration) == 3
    if mode == "template_p1":
        assert float(np.abs(got["params"]["xyz"]).max()) > 0
        assert float(got["aux"]["denom"].max()) == 12.0
    else:
        assert float(np.abs(got["mesh"]["v"] - np.asarray(scene[0].mesh.v)).max()) > 0


def test_ssim_term_within_the_jax_fast_blur(scene):
    jstate, tstate, jl, tl = _run(scene, "template_p1", False, n=1)
    assert abs(tl[0]["ssim"] - jl[0]["ssim"]) <= 3.5e-3 * _opt().lambda_dssim
    _close(tl[0]["img"], jl[0]["img"], rtol=1e-5)


def test_densify_state_matches_jax(scene, monkeypatch):
    _f32_blur(monkeypatch)
    jstate, tstate, _, _ = _run(scene, "template_p1", False)
    counter = np.ones(len(np.asarray(jstate.mesh.f)), np.int32)
    kw = dict(cameras_extent=2.0, max_screen_size=None, binding_counter=counter)
    opt = _opt()
    opt.densify_grad_threshold = 1e-5
    j2, jc, js = JS2.densify_and_prune_state(jstate, opt, rng=np.random.RandomState(0), **kw)
    t2, tc, ts = TS2.densify_and_prune_state(tstate, opt, rng=np.random.RandomState(0), **kw)
    assert ts == js and js["n_clone"] + js["n_split"] > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(t2.binding.numpy(), np.asarray(j2.binding))
    for k in TG.PARAM_NAMES:
        _close(getattr(t2.params, k).numpy(), getattr(j2.params, k), rtol=0, atol=1e-5, err_msg=k)
    t2 = TS2.reset_opacity_state(t2)
    j2 = JS2.reset_opacity_state(j2)
    _close(t2.params.opacity.numpy(), j2.params.opacity, rtol=0, atol=1e-5)


def test_state_round_trip(scene):
    tree = jax.tree.map(np.asarray, scene[0])
    back = s2_state_to_jax(s2_state_from_jax(tree, device="cpu"))
    _close(back["mesh"]["nn_normals"], tree.mesh.nn_normals)
    _close(back["splat_adam"]["mu"]["xyz"], tree.splat_adam.mu.xyz)
    assert back["mesh"]["has_body"] and back["binding"].dtype == np.int32


def test_driver_drive_writes_the_layout(tmp_path):
    """The port's driver from the command line on a tiny dataset (6×6 sheet,
    48², 3 cameras, 2 frames): template mode, then sequence mode."""
    env = dict(os.environ, GG_DATA_ROOT=str(tmp_path / "data"),
               GG_OUTPUT_ROOT=str(tmp_path / "out"), GG_AUX_ROOT=str(tmp_path / "aux"),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [
                   x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    code = ("from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout\n"
            f"write_reference_layout({str(tmp_path / 'data')!r}, {str(tmp_path / 'out')!r}, "
            "'subj', 'seq', n_cams=3, n_frames=2, nx=6, ny=6, res=48, device='cpu')\n")
    run = lambda *args: subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                                       capture_output=True, text=True, timeout=600)
    res = run("-c", code)
    assert res.returncode == 0, res.stderr
    common = ["-m", "gaussian_garments_tpu_torch.s2_registration", "-s", "subj", "-q", "seq",
              "--cameras_per_step", "2", "--device", "cpu"]
    res = run(*common, "-tf", "0", "--first_frame_iterations", "4",
              "--ff_collision_iteration", "2", "--densify_from_iter", "1",
              "--densification_interval", "2", "--densify_grad_threshold", "0")
    assert res.returncode == 0, res.stderr
    res = run(*common, "-t", "Template", "--first_frame_iterations_cross", "2",
              "--other_frame_iterations", "2", "--collision_iteration", "1",
              "--ff_collision_iteration", "1", "--use_icp")
    assert res.returncode == 0, res.stderr
    stage2 = tmp_path / "out" / "subj" / "stage2"
    for f in ("local_point_cloud.ply", "point_cloud.ply", "binding.pkl", "template.obj",
              "template_render.png"):
        assert (stage2 / "Template" / f).exists(), f
    for f in ("cameras.json", "cfg_args", "input.ply"):
        assert (stage2 / "seq" / f).exists(), f
    for t in range(2):
        for f in (f"meshes/frame_{t:05d}.obj", f"renders/{t:05d}.png",
                  f"logs/frame_{t:05d}.jsonl", f"point_cloud/frame_{t:05d}/binding.pkl",
                  f"point_cloud/frame_{t:05d}/point_cloud.ply"):
            assert (stage2 / "seq" / f).exists(), f
    with open(stage2 / "seq" / "logs" / "frame_00000.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert any(e.get("n_split", 0) + e.get("n_clone", 0) > 0 for e in log)
    assert all(np.isfinite(e["img"]) for e in log if "img" in e)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a GPU, the driver and Simulation raise unless given the CPU."""
    from gaussian_garments_tpu_torch import s2_registration
    from gaussian_garments_tpu_torch.doll import Simulation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        s2_registration.main(["-s", "subj", "-q", "seq", "-tf", "0"])
    with pytest.raises(RuntimeError, match="device"):
        Simulation(str(tmp_path / "missing.pkl"), str(tmp_path))
    with pytest.raises(RuntimeError, match="device"):
        s2_state_from_jax({})
    with pytest.raises(RuntimeError, match="device"):
        make_camera(np.eye(3), np.zeros(3), 100.0, 100.0, 16, 16, 32, 32)
