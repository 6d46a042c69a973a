"""What the s2 vertex step's CUDA graph (``training/s2``, ``training/graph``) rests on,
held on the CPU: binning laid out at its static bound (the layout under
capture) gives the exact table; the constants that binning and SSIM no
longer copy each step equal the ones they copied; the step run on the
graph's inputs (static copies, the per-step scalars as tensors) equals the
eager step; the key follows what the step sees; and the CPU, data-parallel
and ``template_p1`` steps stay eager. The graph itself
runs only on the card: ``tests/test_torch_kernel_cuda.py`` holds it against
the eager step there.
"""
import math
from argparse import ArgumentParser
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.utils import logging as log
from gaussian_garments_tpu_torch.utils import losses

N_CAMS = 3


@pytest.fixture(autouse=True)
def fresh():
    log.disable()
    log.reset()
    yield
    log.disable()
    log.reset()


def _opt():
    from gaussian_garments_tpu_torch.config import OptimizationParams

    parser = ArgumentParser()
    return OptimizationParams(parser).extract(parser.parse_args([]))


def _s2_scene(width=256, height=160, with_body=True):
    """(state, cams, bg) of a ``seq`` step: a 10×10 sheet with its body, seen
    by three cameras of a ring with distinct focal lengths."""
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2

    verts, faces, _ = syn.make_cloth_template(10, 10)
    colors = syn.face_checker_colors(faces, verts)
    ring = [syn.make_camera_ring(N_CAMS, fx=200.0 * (1.0 + 0.1 * i), width=width,
                                 height_px=height, device="cpu")[i] for i in range(N_CAMS)]
    cams = syn.render_ground_truth(ring, verts, faces, colors)
    v0 = verts + np.random.RandomState(0).randn(*verts.shape).astype(np.float32) * 0.01
    params, aux, binding, _ = MG.create_from_template(v0, faces, colors, max_sh_degree=0,
                                                      device="cpu")
    mesh = MM.create(v0, faces, device="cpu")
    if with_body:
        body_v = verts - np.array([0, 0, 0.0005], np.float32)
        mesh = MM.init_body(mesh, body_v, faces, np.arange(len(verts)) % len(faces))
    batch = BatchedCameras.from_cameras(cams)
    assert len(set(batch.tanfovx)) == N_CAMS
    return S2.init_state(params, aux, binding, mesh), batch, torch.zeros(3)


def _s2_projection():
    """The splats of ``_s2_scene`` projected into its first camera, (proj, w, h)."""
    from gaussian_garments_tpu_torch.renderer import _project
    from gaussian_garments_tpu_torch.training import s2 as S2

    state, cams, _ = _s2_scene()
    bundle = S2.splat_bundle(state.params, state.binding, state.aux.alive, state.mesh.v,
                             state.mesh.f)
    proj = _project(bundle, cams.world_view[0], cams.full_proj[0], cams.campos[0],
                    width=cams.width, height=cams.height, tanfovx=cams.tanfovx[0],
                    tanfovy=cams.tanfovy[0], scaling_modifier=1.0, vis_mask=None,
                    screen_offset=None)
    return proj, cams.width, cams.height


def _cull_projection():
    """``make_cull_scene`` with dead splats (a zero radius, an opacity under
    1/255) and splats whose rect exceeds the 6-tile window, (proj, w, h)."""
    from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene

    w, h = 192, 128
    proj = make_cull_scene(400, 3, width=w, height=h, device="cpu")
    radii, opacity, conic = proj.radii.clone(), proj.opacity.clone(), proj.conic.clone()
    wide = torch.arange(3, 400, 23)
    conic[wide] = torch.tensor([1.0 / 60.0 ** 2, 0.0, 1.0 / 40.0 ** 2])
    radii[wide] = 180
    radii[1::17] = 0
    opacity[2::19] = 0.5 / 255.0
    return proj._replace(radii=radii, opacity=opacity, conic=conic), w, h


@pytest.mark.parametrize("scene", ["s2", "cull"])
def test_padded_binning_equals_exact(scene):
    proj, w, h = _s2_projection() if scene == "s2" else _cull_projection()
    tx, ty = tiles.tile_grid(w, h)
    side = 6
    ell = tiles.ellipse(proj)
    exact = tiles._bin(proj, ell, tx, ty, side)
    padded = tiles._bin(proj, ell, tx, ty, side, padded=True)
    total = int(exact.ranges[-1])
    n = proj.means2d.shape[0]
    assert total == exact.pair_splat.shape[0] > 0
    assert padded.pair_splat.shape[0] == n * side * side
    assert torch.equal(padded.ranges, exact.ranges)
    assert torch.equal(padded.pair_splat[:total], exact.pair_splat)
    assert padded.pair_splat.dtype == torch.int32 and padded.ranges.dtype == torch.int32
    assert int(padded.n_clipped) == int(exact.n_clipped)
    if scene == "cull":
        rects = tiles.tile_rects(proj, tiles_x=tx, tiles_y=ty)
        alive = rects[4]
        assert int(exact.n_clipped) > 0
        assert not bool(alive[1::17].any()) and not bool(alive[2::19].any())


def test_cached_rect_constants_and_window_equal_todays():
    size, grid, zero = tiles._rect_constants(torch.device("cpu"), torch.float32, 7, 5)
    want = torch.tensor([[tiles.TILE_W, tiles.TILE_H], [7, 5], [0, 0]], dtype=torch.float32)
    assert torch.equal(torch.stack([size, grid, zero]), want)
    assert size.dtype == torch.float32
    w = losses._gaussian_window(11, 1.5, torch.device("cpu"))
    g = torch.tensor([math.exp(-((x - 5) ** 2) / float(2 * 1.5 ** 2)) for x in range(11)],
                     dtype=torch.float32)
    assert torch.equal(w, g / g.sum())
    # made once: a second call copies nothing and counts no sync
    before = log.counters().get("host_syncs", 0)
    again = tiles._rect_constants(torch.device("cpu"), torch.float32, 7, 5)
    assert all(a is b for a, b in zip(again, (size, grid, zero)))
    assert losses._gaussian_window(11, 1.5, torch.device("cpu")) is w
    assert log.counters().get("host_syncs", 0) == before


def test_step_on_the_graphs_inputs_equals_the_eager_step(monkeypatch):
    """The step on its graph path (``graph_path_on_the_cpu``: the walker's
    static copies, the learning rate, the bias corrections and the cameras'
    ``tanfov`` as float64 tensors, the outputs cloned and rebuilt as a
    replay's are) against the eager step, for two steps (the second with its
    Adam state) through one key; the caller's state is not written."""
    from test_torch_s3_graph import graph_path_on_the_cpu

    from gaussian_garments_tpu_torch.training import graph
    from gaussian_garments_tpu_torch.training import s2 as S2

    state, cams, bg = _s2_scene()
    kept = [t.clone() for t in graph.flatten((state, cams, bg))[0]]
    built = graph_path_on_the_cpu(monkeypatch)
    step = S2.make_s2_step(_opt(), mode="seq", use_body=True)
    lr = 1.6e-3
    eager_state, graph_state = state, state
    for _ in range(2):
        eager_state, e_loss, e_metrics = step.eager(eager_state, cams, bg, lr, lr)
        graph_state, g_loss, g_metrics = step(graph_state, cams, bg, lr, lr)
        assert list(g_loss) == list(e_loss)
        for k in e_loss:
            torch.testing.assert_close(g_loss[k], e_loss[k], rtol=1e-6, atol=0)
        for k in e_metrics:
            torch.testing.assert_close(g_metrics[k], e_metrics[k], rtol=1e-6, atol=0)
        torch.testing.assert_close(graph_state.mesh.v, eager_state.mesh.v, rtol=0, atol=1e-6)
        torch.testing.assert_close(graph_state.vert_adam.mu, eager_state.vert_adam.mu,
                                   rtol=1e-4, atol=1e-9)
    assert graph_state.vert_adam.step == eager_state.vert_adam.step == 2
    assert graph_state.iteration == eager_state.iteration == 2
    assert len(built) == 1
    now = graph.flatten((state, cams, bg))[0]
    assert len(now) == len(kept) and all(torch.equal(a, b) for a, b in zip(now, kept))


def test_graph_key_follows_what_the_step_sees():
    """The key of a vertex step's graph differs by the camera count, the
    body and the image size, and stays when only values move: the
    vertices, the host's step counts and the learning rate."""
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import graph
    from gaussian_garments_tpu_torch.training import s2 as S2

    state, cams, bg = _s2_scene()
    step = S2.make_s2_step(_opt(), mode="seq", use_body=True)

    def key(state, cams, lr=1.6e-3):
        _, args, extra = step.graph_call(state, cams, bg, lr)
        return extra, graph.flatten(args)[2]

    base = key(state, cams)
    moved = state.replace(mesh=state.mesh.replace(v=state.mesh.v + 0.01),
                          vert_adam=state.vert_adam._replace(step=4), iteration=9)
    assert key(moved, cams, lr=2e-3) == base
    two = BatchedCameras(**{**cams.__dict__, "world_view": cams.world_view[:2],
                            "full_proj": cams.full_proj[:2], "campos": cams.campos[:2],
                            "image": cams.image[:2], "mask": cams.mask[:2],
                            "tanfovx": cams.tanfovx[:2], "tanfovy": cams.tanfovy[:2]})
    no_body, _, _ = _s2_scene(with_body=False)
    small, small_cams, _ = _s2_scene(width=128, height=96)
    keys = {base, key(state, two), key(no_body, cams), key(small, small_cams)}
    assert len(keys) == 4


def test_cpu_and_group_steps_stay_eager(tmp_path):
    """On the CPU, and with a ``group`` (one gloo rank here), the step runs
    eagerly: no capture, no replay, and binning reads its pair count."""
    from gaussian_garments_tpu_torch.parallel import Group
    from gaussian_garments_tpu_torch.training import s2 as S2

    state, cams, bg = _s2_scene(width=64, height=64)
    log.enable()
    step = S2.make_s2_step(_opt(), mode="seq", use_body=True)
    for _ in range(2):
        state, _, _ = step(state, cams, bg, 1.6e-3, 1.6e-3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        grouped = S2.make_s2_step(_opt(), mode="template_p2", use_body=True,
                                  group=Group(0, 1, "gloo"))
        state, _, _ = grouped(state, cams, bg, 1.6e-3, 1.6e-3)
    finally:
        dist.destroy_process_group()
    counts = log.counters()
    assert "s2_graph.capture" not in counts and "s2_graph.replay" not in counts
    assert "replay" not in {r.name for r in log.records()}
    assert all(log.counters(i)["host_syncs"] >= N_CAMS for i in range(3))
    assert state.iteration == 3

    card = SimpleNamespace(is_cuda=True)
    assert S2._runs_as_graph("seq", card, None) and S2._runs_as_graph("template_p2", card, None)
    assert not S2._runs_as_graph("template_p1", card, None)
    assert not S2._runs_as_graph("seq", card, Group(0, 1, "nccl"))
    assert not S2._runs_as_graph("seq", torch.zeros(1), None)
