"""The stage-3 slice as a whole: the port's ``make_s3_step`` and
``make_s3_eval`` against the JAX package's, both started from one state
(``s3_state_from_jax`` of a Flax-initialised ``S3State``) at texture 32 and
SH degree 1 on ``tests/test_s3.py``'s synthetic scene (2 items, 64×64), the
JAX side on the CPU with its tiled backend. Then checkpoints in both
directions, a CPU drive of the port's ``s3_appearance`` after a short port s2 run, and
the device default.

The JAX step blurs for SSIM with a 3-pass bf16 matmul (``fast=True``, a TPU
speed trade, ≤3.5e-3 on the SSIM value); the port blurs in full f32. The
parity runs hand the JAX step its own f32 blur, so the two differ by f32
summation order only (the UNet's ~25 convolutions sum in another order in
XLA and in PyTorch, ``tests/test_torch_avatar_net.py``):
- loss terms: rtol 1e-4;
- net and splat parameters: Adam moves each parameter by at most ~lr a step
  whatever its gradient, so a parameter whose gradient is near zero, and
  known only to a large relative rounding error, can move by up to lr in
  either direction. Here every splat gradient also passes through the UNet
  (the splats' local xyz and SH are offset by its output), so that rounding
  reaches the splats too, unlike in ``tests/test_torch_s2_step.py``. Each
  group is held to 1% of the most three steps can move it (3·lr) for 99% of
  its entries and to 2·3·lr for all;
- the eval render: atol 1e-4 (the UNet's output, as above).
The SSIM term with the JAX loss's own ``fast=True`` blur is held to its stated
3.5e-3·λ_dssim on the port's eval render.

The suite runs six test processes on the CPU at once; this file runs torch on
two threads, since more threads per process only contend.
"""
import os
import subprocess
import sys
from argparse import ArgumentParser, Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.config import OptimizationParams
from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.data.baker import bake_textures
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet
from gaussian_garments_tpu.renderer import RasterConfig as JCfg
from gaussian_garments_tpu.training import checkpoints as jckpt
from gaussian_garments_tpu.training import s3 as JS3
from gaussian_garments_tpu.utils import losses as JL
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.models import gaussian as TG
from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet as TAvatarNet
from gaussian_garments_tpu_torch.training import checkpoints as tckpt
from gaussian_garments_tpu_torch.training import s3 as TS3
from gaussian_garments_tpu_torch.utils.io import read_obj

REPO = Path(__file__).resolve().parent.parent
RES, DEG, B, HW = 32, 1, 2, 64
# tiles of 16 px holding every splat of the scene: no overflow in the JAX
# tiled backend, which would drop splats the port keeps
CFG = JCfg(tile_capacity=1024, chunk_tiles=16)
LR = 5e-4


def _args():
    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    return Namespace(**{**vars(opt), "lr_init": LR})


@pytest.fixture(scope="module")
def case():
    cams, verts, faces, uvs, colors = jsyn.make_scene(n_cams=B, nx=8, ny=8, width=HW, height=HW)
    jbind, _ = JAG.build_binding(uvs, faces, RES)
    tbind, _ = TAG.build_binding(uvs, faces, RES, device="cpu")
    n = int(jbind.binding.shape[0])
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    splats = {"xyz": np.zeros((n, 3)), "features_dc": rng.randn(n, 1, 3) * 0.3,
              "features_rest": rng.randn(n, 3, 3) * 0.05,
              "scaling": rng.randn(n, 3) * 0.2 - 4.0,
              "rotation": np.array([[1.0, 0, 0, 0]]) + rng.randn(n, 4) * 0.2,
              "opacity": rng.randn(n, 1) * 0.5 + 1.0}
    splats = {k: f32(v) for k, v in splats.items()}
    amb, nrm = bake_textures(jbind, verts, faces, n_samples=8)
    mesh_v = np.stack([verts + f32(rng.randn(*verts.shape) * 0.005) for _ in range(B)])
    jf = jnp.asarray(faces.astype(np.int32))
    item = dict(
        image=np.stack([np.asarray(c.original_image) for c in cams]),
        mask=np.stack([np.asarray(c.gt_alpha_mask) for c in cams]),
        bg=f32(rng.rand(B, 3)), mesh_v=f32(mesh_v),
        ambient=np.stack([amb] * B), normal=np.stack([nrm] * B),
        world_view=np.stack([np.asarray(c.world_view_transform) for c in cams]),
        full_proj=np.stack([np.asarray(c.full_proj_transform) for c in cams]),
        campos=np.stack([np.asarray(c.camera_center) for c in cams]),
        tanfovx=[c.tanfovx for c in cams], tanfovy=[c.tanfovy for c in cams])
    # the JAX visibility, handed to both steps (the modules test compares them)
    item["vis"] = np.stack([np.asarray(JAG.get_visible_mask_depth(
        jbind, jnp.asarray(mesh_v[b]), jf, jnp.asarray(item["world_view"][b]),
        jnp.asarray(item["full_proj"][b]), image_width=HW, image_height=HW)) for b in range(B)]
    ).astype(np.float32)
    assert 0.2 < item["vis"].mean() < 1.0
    jitem = JS3.S3Item(**{k: jnp.asarray(v) for k, v in item.items()}, width=HW, height=HW)
    titem = TS3.S3Item(**{k: torch.as_tensor(np.asarray(v)) for k, v in item.items()
                          if k not in ("tanfovx", "tanfovy")},
                       tanfovx=tuple(item["tanfovx"]), tanfovy=tuple(item["tanfovy"]),
                       width=HW, height=HW)
    jnet = JAvatarNet(texture_size=RES, sh_degree=DEG)
    jsplats = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in splats.items()})
    jstate = JS3.init_state(jnet, jbind, jsplats, verts, faces, jitem)
    return dict(jbind=jbind, tbind=tbind, jf=jf, tf=torch.as_tensor(faces), jitem=jitem,
                titem=titem, jnet=jnet, tnet=TAvatarNet(RES, DEG), jstate=jstate)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(c, train_gaussians, n=3):
    tstate = tckpt.s3_state_from_jax(jax.tree.map(np.asarray, c["jstate"]), device="cpu")
    kw = dict(sh_degree=DEG, vis_raster_hw=(HW, HW), train_gaussians=train_gaussians)
    jstep = JS3.make_s3_step(c["jnet"], _args(), raster_cfg=CFG, **kw)
    tstep = TS3.make_s3_step(c["tnet"], _args(), **kw)
    jstate, jl, tl = c["jstate"], [], []
    for _ in range(n):
        jstate, jd = jstep(jstate, c["jbind"], c["jf"], c["jitem"])
        tstate, td = tstep(tstate, c["tbind"], c["tf"], c["titem"])
        jl.append({k: float(v) for k, v in jd.items()})
        tl.append({k: float(v) for k, v in td.items()})
    return jstate, tstate, jl, tl


@pytest.fixture(scope="module")
def stepped(case):
    """Three steps of each kind from one state, the JAX step on its f32 blur:
    {train_gaussians: (JAX state, port state, JAX losses, port losses)}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS3, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))
        return {tg: _run(case, tg) for tg in (False, True)}


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


@pytest.mark.parametrize("train_gaussians", [False, True], ids=["pre_train", "full"])
def test_three_steps_match_jax(case, stepped, train_gaussians):
    jstate, tstate, jl, tl = stepped[train_gaussians]
    for j, t in zip(jl, tl):
        assert sorted(t) == sorted(j)
        for k in j:
            _close(t[k], j[k], rtol=1e-4, atol=1e-9, err_msg=k)
    got = tckpt.s3_state_to_jax(tstate)

    def within_adam_steps(diff, lr, what):
        assert np.quantile(diff, 0.99) <= 0.01 * 3 * lr, what
        assert diff.max() <= 2 * 3 * lr, what

    lrs = TS3.splat_lrs(_args())
    for k in TG.PARAM_NAMES:
        diff = np.abs(getattr(got["splats"], k) - np.asarray(getattr(jstate.splats, k)))
        within_adam_steps(diff, lrs[k], k)
    moved = np.abs(np.asarray(jstate.splats.features_dc) -
                   np.asarray(case["jstate"].splats.features_dc)).max()
    assert (moved > 0) == train_gaussians
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    gp, jp = flat(got["net_params"]), flat(jstate.net_params)
    assert gp.keys() == jp.keys()
    within_adam_steps(np.concatenate([np.abs(gp[k] - jp[k]).ravel() for k in jp]), LR, "net")
    assert int(got["iteration"]) == int(jstate.iteration) == 3
    assert int(got["net_adam"].step) == int(jstate.net_adam.step) == 3
    assert int(got["splat_adam"].step) == int(jstate.splat_adam.step) == (3 * train_gaussians)


def _port_eval(c):
    tstate = tckpt.s3_state_from_jax(jax.tree.map(np.asarray, c["jstate"]), device="cpu")
    return TS3.make_s3_eval(c["tnet"], sh_degree=DEG, vis_raster_hw=(HW, HW))(
        tstate, c["tbind"], c["tf"], c["titem"])


def test_ssim_term_within_the_jax_fast_blur(case):
    """The loss's SSIM term, ``1 − ssim·λ``, of the port's eval render against
    the item: the port's f32 blur against the JAX loss's ``fast=True`` blur."""
    from gaussian_garments_tpu_torch.utils.losses import ssim

    rendered, item = _port_eval(case), case["titem"]
    lam = _args().lambda_dssim
    got = 1.0 - float(ssim(rendered, item.image, item.mask)) * lam
    want = 1.0 - float(JL.ssim(*(jnp.asarray(x.numpy()) for x in (rendered, item.image, item.mask)),
                               fast=True)) * lam
    assert 0.0 < got < 1.0
    assert abs(got - want) <= 3.5e-3 * lam


def test_eval_render_matches_jax(case):
    c = case
    kw = dict(sh_degree=DEG, vis_raster_hw=(HW, HW))
    want = JS3.make_s3_eval(c["jnet"], raster_cfg=CFG, **kw)(c["jstate"], c["jbind"], c["jf"],
                                                             c["jitem"])
    got = _port_eval(c)
    assert got.shape == (B, 3, HW, HW)
    assert float(np.asarray(want).std()) > 0.05
    _close(got.numpy(), want, rtol=0, atol=1e-4)


def _optm_tree(stepped):
    """The JAX state after three full steps, as numpy."""
    return jax.tree.map(np.asarray, stepped[True][0])


def test_port_reads_jax_checkpoint(stepped, tmp_path):
    """The JAX trainer's net.pkl + optm.pkl load without jax: the pickled
    GaussianParams and TreeAdam become the port's containers, and the state
    carried over equals the JAX state."""
    jstate = _optm_tree(stepped)
    jckpt.save_s3_ckpt(tmp_path, jstate, epoch=2, active_sh_degree=DEG)
    ck = tckpt.load_s3_ckpt(tmp_path)
    assert ck["epoch"] == 2 and ck["iteration"] == 3
    assert isinstance(ck["net_adam"], tckpt.TreeAdam)
    assert isinstance(ck["splats"], TG.GaussianParams)
    state = tckpt.s3_state_from_jax(ck, device="cpu")
    ref = tckpt.s3_state_from_jax(jstate, device="cpu")
    for k in TG.PARAM_NAMES:
        assert torch.equal(getattr(state.splat_adam.nu, k), getattr(ref.splat_adam.nu, k))
    assert state.net_adam.mu.keys() == ref.net_adam.mu.keys()
    for k, v in ref.net_adam.mu.items():
        assert torch.equal(state.net_adam.mu[k], v), k
    assert state.net_adam.step == state.splat_adam.step == 3


def test_jax_reads_port_checkpoint(stepped, tmp_path):
    jstate = _optm_tree(stepped)
    state = tckpt.s3_state_from_jax(jstate, device="cpu")
    tckpt.save_s3_ckpt(tmp_path, epoch=4, active_sh_degree=DEG, **tckpt.s3_state_to_jax(state))
    assert tckpt.has_s3_ckpt(tmp_path) and jckpt.has_s3_ckpt(tmp_path)
    ck = jckpt.load_s3_ckpt(tmp_path)
    assert ck["epoch"] == 4 and ck["iteration"] == 3
    assert type(ck["splat_adam"]).__module__ == "gaussian_garments_tpu.models.adam"
    _close(ck["splat_adam"].mu.opacity, jstate.splat_adam.mu.opacity, rtol=0, atol=0)
    want = jax.tree_util.tree_leaves(jstate.net_adam.nu)
    got = jax.tree_util.tree_leaves(ck["net_adam"].nu)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, rtol=0, atol=0)
    assert jax.tree_util.tree_structure(ck["net_params"]) == \
        jax.tree_util.tree_structure(jstate.net_params)


def test_cli_drive_writes_the_layout(tmp_path):
    """The port's ``s3_appearance`` from the command line after a short port s2 run
    (6×6 sheet, 48², 3 cameras, 2 frames: 4 train items a epoch, 5 epochs),
    texture 32 and SH degree 1; then a second run resumes after epoch 5."""
    import json

    env = dict(os.environ, OMP_NUM_THREADS="2", GG_DATA_ROOT=str(tmp_path / "data"),
               GG_OUTPUT_ROOT=str(tmp_path / "out"), GG_AUX_ROOT=str(tmp_path / "aux"),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [
                   x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    code = ("from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout\n"
            f"write_reference_layout({str(tmp_path / 'data')!r}, {str(tmp_path / 'out')!r}, "
            "'subj', 'seq', n_cams=3, n_frames=2, nx=6, ny=6, res=48, device='cpu')\n")
    run = lambda *args: subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                                       capture_output=True, text=True, timeout=600)
    assert run("-c", code).returncode == 0
    s2 = ["-m", "gaussian_garments_tpu_torch.s2_registration", "-s", "subj", "-q", "seq",
          "--cameras_per_step", "2", "--device", "cpu"]
    assert run(*s2, "-tf", "0", "--first_frame_iterations", "4",
               "--ff_collision_iteration", "2").returncode == 0
    assert run(*s2, "-t", "Template", "--first_frame_iterations_cross", "2",
               "--other_frame_iterations", "2", "--collision_iteration", "1",
               "--ff_collision_iteration", "1").returncode == 0
    s3 = ["-m", "gaussian_garments_tpu_torch.s3_appearance", "-s", "subj", "--texture_size",
          "32", "--sh_degree", "1", "--save_iterations", "2", "--pre_train_iterations", "1",
          "--device", "cpu"]
    res = run(*s3)
    assert res.returncode == 0, res.stderr
    stage3 = tmp_path / "out" / "subj" / "stage3"
    for f in ("ckpt/net.pkl", "ckpt/optm.pkl", "ckpt/info.txt", "logs/train.jsonl",
              "debug/e01_i000000.png", "debug/e05_i000002.png"):
        assert (stage3 / f).exists(), f
    assert (stage3 / "ckpt" / "info.txt").read_text().strip() == "Epoch 5"
    with open(stage3 / "logs" / "train.jsonl") as f:
        log = [json.loads(line) for line in f]
    losses = [e["img"] for e in log if "img" in e]
    assert len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert sum("eval_psnr" in e for e in log) == 10
    assert (tmp_path / "out" / "subj" / "stage2" / "seq" / "texture" / "frame_00000.npz").exists()
    tmpl = read_obj(tmp_path / "out" / "subj" / "stage1" / "template_uv.obj")
    bind, _ = TAG.build_binding(tmpl["uvs"], tmpl["texture_faces"], 32, device="cpu")
    assert tckpt.load_s3_ckpt(stage3)["splats"].xyz.shape == (bind.binding.shape[0], 3)
    res = run(*s3)
    assert res.returncode == 0 and "Resumed from epoch 5" in res.stdout


@pytest.mark.parametrize("flag", [["--data_parallel"], ["--ckpt_backend", "orbax"]])
def test_cli_refuses_what_is_not_ported(flag, capsys):
    """The two flags that were refused as not ported are now accepted: they
    pass the CLI's checks, say what they do, and the run goes on to the data
    (absent here)."""
    from gaussian_garments_tpu_torch import s3_appearance

    with pytest.raises(FileNotFoundError, match="template_uv.obj"):
        s3_appearance.main(["-s", "subj", "--device", "cpu", *flag])
    out = capsys.readouterr().out
    assert ("no launcher" in out) if flag == ["--data_parallel"] else ("pickle layout" in out)


def test_entry_points_default_to_the_card(monkeypatch):
    from gaussian_garments_tpu_torch import s3_appearance

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        s3_appearance.main(["-s", "subj"])
    with pytest.raises(RuntimeError, match="device"):
        tckpt.s3_state_from_jax({})
