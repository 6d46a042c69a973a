"""Data parallelism of the port (``parallel/``, the steps' ``group``, the
drivers' ``--data_parallel``, ``graft_entry``) on the CPU: two gloo ranks,
each a new process (``parallel.spawn``, joined through a file in a fresh
temporary directory, so concurrent test workers never share a port; each rank
runs torch on one thread and the spawn has a hard deadline).

- The port's 2-rank stage-2 step, in all three modes, against the JAX step
  under ``shard_map`` on 2 of the suite's 8 virtual CPU devices, from one
  seeded state (``tests/test_torch_s2_step.py``'s scene: 4 cameras, 2 a
  rank); the 2-rank stage-3 step (``pre`` and ``full``) likewise on
  ``tests/test_torch_s3_step.py``'s two items, one a rank. Both JAX steps use
  their f32 SSIM blur, as the port's parity tests hand them.
- The same 2-rank steps against the port's own 1-process step.
- The ranks' states equal bit for bit after three steps.
- ``graft_entry.dryrun_multichip(2)``; each driver under 2 ranks against
  its 1-process run.

Tolerances. The stage-2 steps after one step, against both references:
the JAX sharded test's (``tests/test_s2.py:174-185``): loss rtol 1e-4,
vertices and splat xyz atol 1e-6, densification accumulators rtol 1e-4 (atol
1e-7), visibility counts and radii exact. The stage-3 steps after one step:
the JAX sharded test's loss rtol 1e-4 and first net leaf atol 1e-5
(``tests/test_s3.py:227-231``); every other parameter by Adam's rule, since
Adam moves an entry by about lr whatever its gradient, so a near-zero
gradient summed in another order (XLA against PyTorch, or the 2-rank mean
against the whole batch's) flips a step: 99% of the entries within 1% of lr,
all within 2·lr (measured: 13 entries of the 2.36M of one conv weight flip
against the 1-process step, 33 against JAX). The drivers after
several steps, where flipped steps compound: the meshes atol 1e-5, the first
logged losses rtol 1e-4 and the later ones 1e-2, every parameter within the
2·n·lr that n Adam steps can move it apart, and decisions (densification,
binding, step counts, the artifacts' list) exact.
"""
import json
import os
import pickle
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
from gaussian_garments_tpu.models import mesh_gaussian as JMG
from gaussian_garments_tpu.models import mesh_model as JMM
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet
from gaussian_garments_tpu.renderer import BatchedCameras as JBatch, RasterConfig as JCfg
from gaussian_garments_tpu.training import s2 as JS2
from gaussian_garments_tpu.training import s3 as JS3
from gaussian_garments_tpu.utils import losses as JL
from gaussian_garments_tpu_torch import graft_entry, parallel
from gaussian_garments_tpu_torch.parallel import rank_checks
from gaussian_garments_tpu_torch.training.checkpoints import (s2_state_from_jax, s2_state_to_jax,
                                                              s3_state_from_jax, s3_state_to_jax)

REPO = Path(__file__).resolve().parent.parent
LR = 1.6e-3
MODES = (("template_p1", False), ("template_p2", True), ("seq", True))
TIMEOUT = 300


def _spawn_behind(fn, args):
    """``parallel.spawn(fn, 2, args)`` on a thread, so that the two ranks run
    while this process computes its references; ``.result()`` joins it."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(parallel.spawn, fn, 2, args, timeout=TIMEOUT)
    pool.shutdown(wait=False)
    return future


def _opt():
    parser = ArgumentParser()
    return OptimizationParams(parser).extract(parser.parse_args([]))


def _shard_map(step, in_specs, out_specs):
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",))
    to_p = lambda s: P(s) if s else P()
    return jax.jit(shard_map(step, mesh=mesh, in_specs=tuple(map(to_p, in_specs)),
                             out_specs=tuple(map(to_p, out_specs)), check_vma=False))


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2(tmp_path_factory):
    """The JAX state and batch of ``test_torch_s2_step.py``, a case file of
    them, one JAX shard_map step of each mode, and the port's 2-rank and
    1-process runs of three steps of each mode."""
    cams, verts, faces, uvs, colors = jsyn.make_scene(n_cams=4, nx=10, ny=10, width=64, height=64)
    v0 = verts + np.random.RandomState(0).randn(*verts.shape).astype(np.float32) * 0.01
    params, aux, binding, _ = JMG.create_from_template(v0, faces, colors, max_sh_degree=0)
    rng = np.random.RandomState(1)
    params = params.replace(
        scaling=params.scaling + jnp.asarray(rng.randn(*params.scaling.shape) * 0.3, jnp.float32),
        rotation=params.rotation + jnp.asarray(rng.randn(*params.rotation.shape) * 0.3,
                                               jnp.float32))
    nn = np.arange(len(verts)) % len(faces)
    mesh = JMM.init_body(JMM.create(v0, faces), verts - np.array([0, 0, 0.0005], np.float32),
                         faces, nn)
    jstate = JS2.init_state(params, aux, binding, mesh)
    jbatch = JBatch.from_cameras(cams)
    tree = s2_state_to_jax(s2_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu"))
    cams_np = {k: np.asarray(getattr(jbatch, k)) for k in ("world_view", "full_proj", "campos",
                                                             "image", "mask")}
    cams_np.update(tanfovx=[float(x) for x in jbatch.tanfovx],
                   tanfovy=[float(x) for x in jbatch.tanfovy], width=64, height=64)
    case = rank_checks.write_case(tmp_path_factory.mktemp("s2") / "case.pkl", state=tree,
                                  cams=cams_np, bg=np.zeros(3, np.float32), xyz_lr=LR,
                                  vert_lr=LR)
    ranks = _spawn_behind(rank_checks.s2_steps, (case, MODES, 3))

    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS2, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))
        for mode, use_body in MODES:
            step = JS2.make_s2_step(_opt(), mode=mode, use_body=use_body,
                                    raster_cfg=JCfg(tile_capacity=128, chunk_tiles=16),
                                    axis_name="data", jit=False)
            st, ld, m = _shard_map(step, (None, "data", None, None, None),
                                   (None, None, None))(jstate, jbatch, jnp.zeros(3), LR, LR)
            jax_out[mode] = (rank_checks.s2_compared(s2_state_to_jax(
                s2_state_from_jax(jax.tree.map(np.asarray, st), device="cpu"))),
                {k: float(v) for k, v in ld.items()}, {k: float(v) for k, v in m.items()})
    single = rank_checks.s2_steps(case, MODES, 1)
    return jax_out, ranks.result(), single


def _hold_s2(got, want, got_loss, want_loss):
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["params.xyz"], want["params.xyz"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["aux.xyz_gradient_accum"], want["aux.xyz_gradient_accum"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(got["aux.denom"], want["aux.denom"])
    np.testing.assert_array_equal(got["aux.max_radii2d"], want["aux.max_radii2d"])


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_s2_two_ranks_match_jax_shard_map(s2, mode):
    jax_out, ranks, _ = s2
    want, want_ld, want_m = jax_out[mode]
    got = ranks[0][mode]
    _hold_s2(got["states"][0], want, got["metrics"][0]["loss"], want_m["loss"])
    assert sorted(got["losses"][0]) == sorted(want_ld)
    for k, v in want_ld.items():
        np.testing.assert_allclose(got["losses"][0][k], v, rtol=1e-4, atol=1e-9, err_msg=k)
    if mode == "template_p1":
        assert float(got["states"][0]["aux.denom"].max()) == 4.0   # all four cameras counted
        assert float(np.abs(got["states"][0]["params.xyz"]).max()) > 0
    elif mode == "template_p2":
        assert "collision" in got["losses"][0]


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_s2_two_ranks_match_one_process(s2, mode):
    _, ranks, single = s2
    _hold_s2(ranks[0][mode]["states"][0], single[mode]["states"][0],
             ranks[0][mode]["metrics"][0]["loss"], single[mode]["metrics"][0]["loss"])


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_s2_ranks_equal_bit_for_bit(s2, mode):
    _, ranks, _ = s2
    r0, r1 = ranks[0][mode], ranks[1][mode]
    assert r0["digest"] == r1["digest"]
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]
    assert len(r0["losses"]) == 3


# ---------------------------------------------------------------------------
# stage 3
# ---------------------------------------------------------------------------

RES, DEG, HW = 32, 1, 64


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    """``test_torch_s3_step.py``'s two items at texture 32, SH 1: one JAX
    shard_map step of each kind, and the port's 2-rank and 1-process runs."""
    cams, verts, faces, uvs, colors = jsyn.make_scene(n_cams=2, nx=8, ny=8, width=HW, height=HW)
    jbind, _ = JAG.build_binding(uvs, faces, RES)
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
    mesh_v = np.stack([verts + f32(rng.randn(*verts.shape) * 0.005) for _ in range(2)])
    jf = jnp.asarray(faces.astype(np.int32))
    item = dict(
        image=np.stack([np.asarray(c.original_image) for c in cams]),
        mask=np.stack([np.asarray(c.gt_alpha_mask) for c in cams]),
        bg=f32(rng.rand(2, 3)), mesh_v=f32(mesh_v), ambient=np.stack([amb] * 2),
        normal=np.stack([nrm] * 2),
        world_view=np.stack([np.asarray(c.world_view_transform) for c in cams]),
        full_proj=np.stack([np.asarray(c.full_proj_transform) for c in cams]),
        campos=np.stack([np.asarray(c.camera_center) for c in cams]),
        tanfovx=[float(c.tanfovx) for c in cams], tanfovy=[float(c.tanfovy) for c in cams])
    item["vis"] = np.stack([np.asarray(JAG.get_visible_mask_depth(
        jbind, jnp.asarray(mesh_v[b]), jf, jnp.asarray(item["world_view"][b]),
        jnp.asarray(item["full_proj"][b]), image_width=HW, image_height=HW)) for b in range(2)]
    ).astype(np.float32)
    jitem = JS3.S3Item(**{k: jnp.asarray(v) for k, v in item.items()}, width=HW, height=HW)
    jnet = JAvatarNet(texture_size=RES, sh_degree=DEG)
    jstate = JS3.init_state(jnet, jbind, JG.GaussianParams(**{k: jnp.asarray(v) for k, v
                                                             in splats.items()}),
                            verts, faces, jitem)
    tree = s3_state_to_jax(s3_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu"))
    case = rank_checks.write_case(
        tmp_path_factory.mktemp("s3") / "case.pkl", state=tree,
        item={**item, "width": HW, "height": HW}, uvs=uvs, faces=faces, texture_size=RES,
        sh_degree=DEG, vis_hw=(HW, HW), args={"lr_init": 5e-4})
    ranks = _spawn_behind(rank_checks.s3_steps, (case, ("pre", "full"), 3))

    args = Namespace(**{**vars(_opt()), "lr_init": 5e-4})
    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS3, "ssim", lambda *a, fast=False, **k: JL.ssim(*a, **k))
        for kind in ("pre", "full"):
            step = JS3.make_s3_step(jnet, args, sh_degree=DEG,
                                    raster_cfg=JCfg(tile_capacity=1024, chunk_tiles=16),
                                    vis_raster_hw=(HW, HW), train_gaussians=kind == "full",
                                    axis_name="data", jit=False)
            st, ld = _shard_map(step, (None, None, None, "data"), (None, None))(
                jstate, jbind, jf, jitem)
            jax_out[kind] = (rank_checks.s3_compared(s3_state_from_jax(
                jax.tree.map(np.asarray, st), device="cpu")), {k: float(v) for k, v in ld.items()})
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = rank_checks.s3_steps(case, ("pre", "full"), 1)
    finally:
        torch.set_num_threads(n_threads)
    return jax_out, ranks.result(), single


def _within_adam_step(got, want, lr, what):
    """One Adam step moves a parameter by at most lr whatever the size of its
    gradient, so a near-zero gradient summed in another order can flip the
    step: 99% of the entries within 1% of lr, all within 2·lr beyond two
    float32 roundings of the value (2^-22·|p|)."""
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.99) <= 0.01 * lr, what
    assert (diff - 2.0 ** -22 * np.abs(want)).max() <= 2 * lr, what


def _hold_s3(got, want, got_loss, want_loss, grad_atol=1e-5):
    """The JAX sharded test's checks (the loss, the first net leaf at atol
    1e-5), every net and splat parameter within one Adam step's rule, and the
    splats' gradient (Adam's first moment) at rtol 1e-4, atol ``grad_atol`` ×
    its largest entry."""
    np.testing.assert_allclose(sum(got_loss.values()), sum(want_loss.values()), rtol=1e-4)
    net = sorted(k for k in want if k.startswith("net."))
    np.testing.assert_allclose(got[net[0]], want[net[0]], rtol=0, atol=1e-5, err_msg=net[0])
    _within_adam_step(np.concatenate([got[k].ravel() for k in net]),
                      np.concatenate([want[k].ravel() for k in net]), 5e-4, "net")
    lrs = _splat_lrs()
    for k in want:
        if k.startswith("splats."):
            _within_adam_step(got[k], want[k], lrs[k[len("splats."):]], k)
        elif k.startswith("splat_mu."):   # the step's reduced gradient × 0.1
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=grad_atol * np.abs(want[k]).max(), err_msg=k)


def _splat_lrs():
    from gaussian_garments_tpu_torch.training.s3 import splat_lrs

    return splat_lrs(_opt())


@pytest.mark.parametrize("kind", ["pre", "full"])
def test_s3_two_ranks_match_jax_shard_map(s3, kind):
    """The net against the JAX step as the port's 1-process parity test holds
    it (``tests/test_torch_s3_step.py``): XLA and PyTorch sum the UNet's
    convolutions in other orders, and Adam turns that into flipped steps. The
    UNet's output offsets the splats, so their gradients carry that too:
    atol 1e-4 × the largest (measured 6.2e-5 on xyz)."""
    jax_out, ranks, _ = s3
    want, want_ld = jax_out[kind]
    got = ranks[0][kind]
    _hold_s3(got["states"][0], want, got["losses"][0], want_ld, grad_atol=1e-4)
    assert sorted(got["losses"][0]) == sorted(want_ld)


@pytest.mark.parametrize("kind", ["pre", "full"])
def test_s3_two_ranks_match_one_process(s3, kind):
    _, ranks, single = s3
    _hold_s3(ranks[0][kind]["states"][0], single[kind]["states"][0], ranks[0][kind]["losses"][0],
             single[kind]["losses"][0])


@pytest.mark.parametrize("kind", ["pre", "full"])
def test_s3_ranks_equal_bit_for_bit(s3, kind):
    _, ranks, _ = s3
    assert ranks[0][kind]["digest"] == ranks[1][kind]["digest"]
    assert ranks[0][kind]["losses"] == ranks[1][kind]["losses"]
    moved = np.abs(ranks[0][kind]["states"][-1]["splats.features_dc"]
                   - ranks[0][kind]["states"][0]["splats.features_dc"]).max()
    assert (moved > 0) == (kind == "full")


# ---------------------------------------------------------------------------
# the library pieces, the dry run and the drivers
# ---------------------------------------------------------------------------

def test_shard_blocks_and_identity_without_group():
    g = lambda r: parallel.Group(r, 4, "gloo")
    assert [parallel.shard(list(range(8)), g(r)) for r in range(4)] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        parallel.shard(list(range(6)), g(0))
    tree = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    for f in (parallel.pmean, parallel.psum, parallel.pmax, parallel.broadcast_from_rank0):
        assert f(tree, None) is tree


def test_launch_guard_refuses_another_device(monkeypatch):
    """A kernel launch on a tensor whose device is not the current one raises
    instead of launching into another device's stream."""
    from gaussian_garments_tpu_torch.ops import cuda as C

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="current CUDA device is cuda:1"):
        C.stream(torch.device("cuda", 0))


def test_graft_entry_defaults_to_the_card(monkeypatch):
    """Without a GPU the forward entry and its command raise unless given the
    CPU; the command raises before it starts the dry run's ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(graft_entry, "dryrun_multichip", lambda n: pytest.fail("dry run ran"))
    with pytest.raises(RuntimeError, match="device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device"):
        graft_entry.main(["--n", "2"])
    fn, example = graft_entry.entry(device="cpu")
    assert tuple(fn(*example).shape) == (2, 3, 64, 64)


def test_dryrun_multichip_two_ranks():
    r0 = graft_entry.dryrun_multichip(2, timeout=TIMEOUT)
    assert "collision" in r0["template_p2"]["losses"]
    assert all(np.isfinite(r0[m]["loss"]) for m in ("template_p1", "template_p2", "seq"))


def _env(tmp_path, out):
    return dict(os.environ, GG_DATA_ROOT=str(tmp_path / "data"), GG_OUTPUT_ROOT=str(out),
                GG_AUX_ROOT=str(tmp_path / "aux"),
                PYTHONPATH=os.pathsep.join([str(REPO)] + [
                    x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))


def _run_both(tmp_path, mp, module, argv, out1="out1", out2="out2"):
    """``module.main(argv)`` as one process (a subprocess) into ``out1`` and,
    at the same time, under 2 gloo ranks with ``--data_parallel`` into
    ``out2``; returns the ranks' stats."""
    log = tmp_path / f"{out1}.log"
    with open(log, "w") as f:
        one = subprocess.Popen([sys.executable, "-m", module.__name__, *argv], cwd=REPO,
                               env=_env(tmp_path, tmp_path / out1), stdout=f, stderr=f)
    try:
        for k, v in _env(tmp_path, tmp_path / out2).items():
            mp.setenv(k, v)
        ranks = parallel.spawn(module.main, 2, ([*argv, "--data_parallel"],), timeout=TIMEOUT)
        one.wait(timeout=TIMEOUT)
    finally:
        one.kill()
    assert one.returncode == 0, log.read_text()[-3000:]
    return ranks


S2_TEMPLATE = ["-s", "subj", "-q", "seq", "--cameras_per_step", "2", "--device", "cpu", "-tf",
               "0", "--first_frame_iterations", "4", "--ff_collision_iteration", "2",
               "--densify_from_iter", "1", "--densification_interval", "2",
               "--densify_grad_threshold", "0"]
S2_SEQ = ["-s", "subj", "-q", "seq", "--cameras_per_step", "2", "--device", "cpu", "-t",
          "Template", "--first_frame_iterations_cross", "2", "--other_frame_iterations", "2",
          "--collision_iteration", "1", "--ff_collision_iteration", "1"]


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """A tiny stage-2 dataset (6×6 sheet, 48², 3 cameras, 2 frames); the s2
    driver's template and sequence runs as one process (``out1``) and as two
    ranks (``out2``); then ``out1``'s stage 2 copied to ``out3``, and the s3
    driver as one process on ``out1`` and as two ranks on ``out3``."""
    import shutil

    from gaussian_garments_tpu_torch import s2_registration, s3_appearance
    from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout

    tmp = tmp_path_factory.mktemp("drivers")
    write_reference_layout(tmp / "data", tmp / "out1", "subj", "seq", n_cams=3, n_frames=2,
                           nx=6, ny=6, res=48, device="cpu")
    shutil.copytree(tmp / "out1", tmp / "out2")
    with pytest.MonkeyPatch.context() as mp:
        s2_stats = [_run_both(tmp, mp, s2_registration, argv) for argv in (S2_TEMPLATE, S2_SEQ)]
        shutil.copytree(tmp / "out1", tmp / "out3")
        argv = ["-s", "subj", "--texture_size", "32", "--sh_degree", "1", "--save_iterations",
                "2", "--pre_train_iterations", "1", "--items_per_step", "2", "--eval_items", "1",
                "--ckpt_backend", "orbax", "--device", "cpu"]
        s3_stats = _run_both(tmp, mp, s3_appearance, argv, out2="out3")
    # the fresh state both s3 runs started from (the driver's seeded init)
    res = subprocess.run([sys.executable, "-c", FRESH_S3, str(tmp / "fresh.pkl"), *argv],
                         cwd=REPO, env=_env(tmp, tmp / "out1"), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp / "fresh.pkl", "rb") as f:
        fresh = pickle.load(f)
    return tmp, s2_stats, (s3_stats, fresh)


FRESH_S3 = """import pickle, sys
from gaussian_garments_tpu_torch import s3_appearance
from gaussian_garments_tpu_torch.training.checkpoints import s3_state_to_jax
_, run = s3_appearance.prepare(sys.argv[2:] + ["--ckpt_path", sys.argv[1] + ".d"])
assert run.start_epoch == 1
t = s3_state_to_jax(run.state)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"net_params": t["net_params"], "splats": t["splats"]}, f)
"""
# two right runs of a driver part where flipped Adam steps compound; a run of
# another state, batch or reduction takes other steps at most entries: the
# median part as a share of the median movement (chip_smoke.py holds the
# card's pair to the same)
MEDIAN_PART = {"net": 0.2, "splats": 0.5}


def test_s2_driver_two_ranks_write_the_one_process_artifacts(drivers):
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.utils.io import read_obj

    tmp, s2_stats, _ = drivers
    for stats in s2_stats:
        assert [f["iterations"] for f in stats[0]["frames"]] == \
            [f["iterations"] for f in stats[1]["frames"]]
        assert "train_psnr" in stats[0]["frames"][0]
        assert "train_psnr" not in stats[1]["frames"][0]
    a, b = (tmp / d / "subj" / "stage2" for d in ("out1", "out2"))
    # (stage 3 has since cached its texture bakes in out1's stage 2)
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*")
                             if p.is_file() and p.parent.name != "texture")
    assert files(a) == files(b)
    for t in range(2):
        mesh = lambda d: read_obj(d / "seq" / "meshes" / f"frame_{t:05d}.obj")["vertices"]
        np.testing.assert_allclose(mesh(b), mesh(a), rtol=0, atol=1e-5)
    np.testing.assert_allclose(read_obj(b / "Template" / "template.obj")["vertices"],
                               read_obj(a / "Template" / "template.obj")["vertices"], atol=1e-5)
    # the template's splats: every entry within what its n Adam steps can
    # move it apart (flipped steps of near-zero gradients; the rotations'
    # gradients are small, and 1% of them part by more than lr)
    pa, pb = (G.load_ply(str(d / "Template" / "local_point_cloud.ply"), 0, device="cpu")[0]
              for d in (a, b))
    opt, frame = _opt(), s2_stats[0][0]["frames"][0]
    lrs = {"xyz": opt.position_lr_init * frame["cameras_extent"],
           "features_dc": opt.feature_lr, "features_rest": opt.feature_lr / 20,
           "opacity": opt.opacity_lr, "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
    for k, lr in lrs.items():
        diff = np.abs(getattr(pb, k).numpy() - getattr(pa, k).numpy())
        assert diff.size == 0 or diff.max() <= 2 * frame["iterations"] * lr, k
    with open(a / "Template" / "binding.pkl", "rb") as fa, \
            open(b / "Template" / "binding.pkl", "rb") as fb:
        np.testing.assert_array_equal(pickle.load(fb), pickle.load(fa))
    for f in ("logs/frame_00000.jsonl", "logs/frame_00001.jsonl"):
        assert len((b / "seq" / f).read_text().splitlines()) == \
            len((a / "seq" / f).read_text().splitlines())


def test_s3_driver_two_ranks_write_the_one_process_artifacts(drivers):
    """Two items a step, one a rank, with the orbax flag's asynchronous
    mid-epoch saves: one checkpoint, one set of panels and logs, from rank 0."""
    from gaussian_garments_tpu_torch.training.checkpoints import load_s3_ckpt

    tmp, _, (stats, fresh) = drivers
    assert stats[0]["losses"] == stats[1]["losses"]
    assert stats[0]["eval"] and not stats[1]["eval"]
    a, b = (tmp / d / "subj" / "stage3" for d in ("out1", "out3"))
    assert sorted(p.name for p in (b / "debug").iterdir()) == \
        sorted(p.name for p in (a / "debug").iterdir())
    ca, cb = load_s3_ckpt(a), load_s3_ckpt(b)
    n = ca["iteration"]
    assert ca["epoch"] == cb["epoch"] == 5 and n == cb["iteration"] == 10
    # from one state, the first step's losses agree as the steps' do; then
    # flipped Adam steps (2·lr each) and training itself part the runs a
    # little: the logged losses within 1%, the parameters within the most
    # that n Adam steps can move them apart and, over the entries either run
    # moved, at the median within MEDIAN_PART of how far they moved
    logs = [[json.loads(x) for x in (d / "logs" / "train.jsonl").read_text().splitlines()
             if '"img"' in x] for d in (a, b)]
    assert len(logs[0]) == len(logs[1]) == 5
    for i, (la, lb) in enumerate(zip(*logs)):
        for k in ("img", "ssim"):
            np.testing.assert_allclose(lb[k], la[k], rtol=1e-4 if i == 0 else 1e-2, err_msg=k)
    lrs = _splat_lrs()
    for k, lr in lrs.items():
        assert np.abs(getattr(cb["splats"], k) - getattr(ca["splats"], k)).max() <= 2 * n * lr, k
    fa, fb = _flat(ca["net_params"]), _flat(cb["net_params"])
    assert fa.keys() == fb.keys()
    assert max(float(np.abs(fb[k] - fa[k]).max()) for k in fa) <= 2 * n * 5e-4
    groups = lambda ck: {"net": np.concatenate([v.ravel() for v in _flat(ck["net_params"])
                                                .values()]),
                         **{k: np.asarray(getattr(ck["splats"], k)).ravel() for k in lrs}}
    ga, gb, g0 = groups(ca), groups(cb), groups(fresh)
    for k in ga:
        live = (ga[k] != g0[k]) | (gb[k] != g0[k])
        assert live.any(), k
        part, moved = (float(np.median(x[live])) for x in (np.abs(gb[k] - ga[k]),
                                                           np.abs(ga[k] - g0[k])))
        bound = MEDIAN_PART["net" if k == "net" else "splats"]
        assert part <= bound * moved, (k, part, moved)
    assert not list(b.glob("ckpt.tmp-*"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out
