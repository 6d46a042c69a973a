"""``s3_appearance --unet_bf16`` in the port against the JAX package, on the
CPU: AvatarNet with bf16 activations over float32 master weights.

- The net: the port's bf16 AvatarNet and Flax's ``AvatarNet(act_dtype=
  bfloat16)`` on the same Flax-initialised weights at texture 64 (both cast
  their weights at apply time, ``_cast_net_vars``). The bound calibrates
  itself: the port's distance to Flax's bf16 output, as the largest element
  and as the norm of the difference, must not exceed Flax's own bf16-to-f32
  distance by the same measure. Both round each op to bf16; they differ where
  XLA and PyTorch order a convolution's sums, and in the transposed
  convolution (PyTorch's ``conv_transpose2d``, XLA's dilated convolution).
  The port's output is also nearer Flax's bf16 output than Flax's float32
  one, so that a port which rounds only in part fails.
- The eval render from one state (``tests/torch_s3_case.py``): the port's
  bf16 render is no further from its float32 render than the JAX package's
  bf16 render is from its own, and at least half as far (mean squared
  error).
- The same on a state the port trained for 40 steps: the port's bf16 render
  within a factor 2 of the JAX package's distance from its float32 render,
  and nearer the JAX package's bf16 render than that is to its float32 one.
  On a trained net the bf16 Δxyz moves each splat by up to its rounding,
  which the render magnifies (about 30 dB from float32 in both packages).
- One s3 step from that state: each loss of the
  port's bf16 step within 5% of the port's float32 step and of the JAX bf16
  step (``tests/test_s3.py::TestUNetBf16``'s bound: 5% of max(|loss|, 0.02)).
- The masters: after a bf16 step the net's weights, both Adam moments and the
  splats stay float32, and so does what ``net.pkl`` and ``optm.pkl`` hold.
- A CPU drive of ``s3_appearance --unet_bf16`` and its resume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet
from gaussian_garments_tpu.training import checkpoints as jckpt
from gaussian_garments_tpu.training import s3 as JS3
from gaussian_garments_tpu.utils import losses as JL
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG
from gaussian_garments_tpu_torch.models import mesh_gaussian as TMG
from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet as TAvatarNet
from gaussian_garments_tpu_torch.training import checkpoints as tckpt
from gaussian_garments_tpu_torch.training import s3 as TS3
import torch_bf16_trained as bf16_trained
from torch_s3_case import (CFG, DEG, HW, RES, build_case, jax_item, port_item, run_s3,
                           s3_args, write_s3_layout)

T = torch.from_numpy
NET_RES = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net_case():
    """Flax weights from a seed, the inputs, and Flax's float32 and bf16 outputs."""
    verts, faces, uvs = jsyn.make_cloth_template(7, 6)
    verts = verts + np.random.RandomState(3).randn(*verts.shape).astype(np.float32) * 0.02
    jbind, jmap = JAG.build_binding(uvs, faces, NET_RES)
    rng = np.random.RandomState(1)
    ambient = rng.rand(1, NET_RES, NET_RES).astype(np.float32)
    normal = (rng.rand(3, NET_RES, NET_RES) * (jmap > -1)[None]).astype(np.float32)
    cam = jsyn.make_camera_ring(1, radius=0.5, height=2.0, width=64, height_px=64)[0]
    jv, jf = jnp.asarray(verts), jnp.asarray(faces.astype(np.int32))
    args = (jnp.asarray(ambient), jnp.asarray(normal), cam.world_view_transform,
            cam.camera_center, jbind, jv, jf, JMG.compute_face_frames(jv, jf))
    j32 = JAvatarNet(texture_size=NET_RES, sh_degree=DEG)
    jbf = JAvatarNet(texture_size=NET_RES, sh_degree=DEG, act_dtype=jnp.bfloat16)
    variables = j32.init(jax.random.PRNGKey(0), *args)
    return dict(
        out32=np.asarray(j32.apply(variables, *args)),
        outbf=np.asarray(jbf.apply(JS3._cast_net_vars(jbf, variables), *args)),
        state=tckpt.avatar_net_state_from_jax(jax.tree.map(np.asarray, variables["params"]),
                                              jax.tree.map(np.asarray, variables["buffers"])),
        ambient=ambient, normal=normal, cam=cam, verts=verts, faces=faces,
        tbind=TAG.build_binding(uvs, faces, NET_RES, device="cpu")[0])


def test_bf16_net_within_flax_bf16_rounding(net_case):
    c = net_case
    net = TAvatarNet(NET_RES, DEG, act_dtype=torch.bfloat16)
    params = {k: c["state"][k] for k, _ in net.named_parameters()}
    buffers = {k: c["state"][k] for k, _ in net.named_buffers()}
    assert all(v.dtype == torch.float32 for v in params.values())
    tv, tf = T(c["verts"]), T(c["faces"])
    with torch.no_grad():
        out = functional_call(net, TS3._cast_net_vars(net, (params, buffers)), (
            T(c["ambient"]), T(c["normal"]), T(np.asarray(c["cam"].world_view_transform)),
            T(np.asarray(c["cam"].camera_center)), c["tbind"], tv, tf,
            TMG.compute_face_frames(tv, tf)))
    assert out.dtype == torch.float32 and out.shape == c["outbf"].shape
    got, ref = out.numpy() - c["outbf"], c["outbf"] - c["out32"]
    assert np.abs(ref).max() > 1e-3            # bf16 really moved Flax's output
    assert np.abs(got).max() <= np.abs(ref).max()
    assert np.linalg.norm(got) <= np.linalg.norm(ref)
    # and the port rounds: its output is nearer Flax's bf16 output than Flax's
    # float32 one (a float32 port would sit on the latter)
    assert np.linalg.norm(got) < np.linalg.norm(out.numpy() - c["out32"])


@pytest.fixture(scope="module")
def case():
    c = build_case()
    c["tbind"] = TAG.build_binding(c["uvs"], c["faces"], RES, bind_map=c["bind_map"],
                                   device="cpu")[0]
    c["tstate"] = tckpt.s3_state_from_jax(jax.tree.map(np.asarray, c["jstate"]), device="cpu")
    return c


def test_bf16_render_as_close_to_f32_as_jax(case):
    """The eval render of the bf16 net against the float32 net's, from one
    state: the port's bf16 render is no further from its float32 render than
    the JAX package's is from its own, and at least half as far (mean
    squared error)."""
    c, kw = case, dict(sh_degree=DEG, vis_raster_hw=(HW, HW))
    imgs = {}
    for name, (jdt, tdt) in {"f32": (jnp.float32, torch.float32),
                             "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        jnet = JAvatarNet(texture_size=RES, sh_degree=DEG, act_dtype=jdt)
        imgs["jax", name] = np.clip(np.asarray(JS3.make_s3_eval(jnet, raster_cfg=CFG, **kw)(
            c["jstate"], c["jbind"], c["jf"], jax_item(c["item"]))), 0, 1)
        tnet = TAvatarNet(RES, DEG, act_dtype=tdt)
        imgs["port", name] = torch.clamp(TS3.make_s3_eval(tnet, **kw)(
            c["tstate"], c["tbind"], c["tf"], port_item(c["item"])), 0, 1).numpy()
    err = lambda pkg: float(np.mean((imgs[pkg, "bf16"] - imgs[pkg, "f32"]) ** 2))
    assert 0 < err("jax")
    assert 0.5 * err("jax") <= err("port") <= err("jax")


def test_bf16_render_on_a_trained_state_as_jax(case):
    """The same on a state the port trained for 40 float32 steps
    (``tests/torch_bf16_trained.py``): the port's bf16 render within a
    factor 2 of the JAX package's distance from its float32 render (mean
    squared error), and nearer the JAX package's bf16 render than that is to
    its float32 render."""
    r = bf16_trained.renders(case, bf16_trained.train(case, RES, 40), RES)
    mse = bf16_trained.mse
    jax_gap = mse(r["jax", "bf16"], r["jax", "f32"])
    assert 0 < jax_gap
    assert 0.5 * jax_gap <= mse(r["port", "bf16"], r["port", "f32"]) <= 2 * jax_gap
    assert mse(r["port", "bf16"], r["jax", "bf16"]) < jax_gap


@pytest.fixture(scope="module")
def stepped(case):
    """One step of each: the port in float32 and in bf16, JAX in bf16, from
    one state; the JAX step on its float32 SSIM blur, as the port's."""
    c = case
    tbind, state = c["tbind"], c["tstate"]
    kw = dict(sh_degree=DEG, vis_raster_hw=(HW, HW))
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        step = TS3.make_s3_step(TAvatarNet(RES, DEG, act_dtype=dtype), s3_args(), **kw)
        out[name] = step(state, tbind, c["tf"], port_item(c["item"]))
    jnet = JAvatarNet(texture_size=RES, sh_degree=DEG, act_dtype=jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS3, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))
        jstep = JS3.make_s3_step(jnet, s3_args(), raster_cfg=CFG, **kw)
        out["jax_bf16"] = jstep(c["jstate"], c["jbind"], c["jf"], jax_item(c["item"]))
    return out


@pytest.mark.parametrize("against", ["f32", "jax_bf16"])
def test_bf16_step_close(stepped, against):
    got, want = stepped["bf16"][1], stepped[against][1]
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = float(want[k]), float(got[k])
        assert np.isfinite(b), k
        assert abs(a - b) <= 0.05 * max(abs(a), 0.02), (k, a, b)


def test_bf16_step_keeps_float32_masters(stepped, tmp_path):
    state = stepped["bf16"][0]
    for tree in (state.net_params, state.net_adam.mu, state.net_adam.nu):
        assert all(v.dtype == torch.float32 for v in tree.values())
    for k in ("xyz", "opacity"):
        assert getattr(state.splats, k).dtype == torch.float32
    moved = [float((state.net_params[k] - stepped["f32"][0].net_params[k]).abs().max())
             for k in state.net_params]
    assert max(moved) > 0
    tckpt.save_s3_ckpt(tmp_path, epoch=1, active_sh_degree=DEG, **tckpt.s3_state_to_jax(state))
    ck = jckpt.load_s3_ckpt(tmp_path)
    leaves = jax.tree_util.tree_leaves((ck["net_params"], ck["net_adam"].mu, ck["splats"]))
    assert leaves and all(np.asarray(x).dtype == np.float32 for x in leaves)


def test_cli_drive_unet_bf16(tmp_path, monkeypatch):
    """``s3_appearance --unet_bf16`` from its entry point: 20 steps, finite
    losses, a float32 checkpoint, the debug panels; then it resumes."""
    roots = write_s3_layout(tmp_path)
    stats = run_s3(["--unet_bf16"], roots, monkeypatch)
    assert stats["steps"]["pre"]["n"] + stats["steps"]["full"]["n"] == 20
    losses = [e["img"] for e in stats["losses"]]
    assert all(np.isfinite(losses))
    stage3 = roots["out"] / "subj" / "stage3"
    assert (stage3 / "debug" / "e01_i000000.png").exists()
    ck = tckpt.load_s3_ckpt(stage3)
    assert ck["epoch"] == 5
    net = tckpt.avatar_net_state_from_jax(ck["net_params"], ck["net_buffers"])
    assert all(v.dtype == torch.float32 for v in net.values())
    assert run_s3(["--unet_bf16"], roots, monkeypatch)["losses"] == []
