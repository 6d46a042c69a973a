"""The port's spans and counters (``utils/logging.py``): a span that is off
records nothing; under ``torch.profiler`` spans nest, their self times add
up to the root, and their clock is the trace's; ``count`` adds to the step
and to the process; one tiny s2 ``seq`` step and one tiny s3 ``full`` step
record every layer span and count their host syncs.

The test marked ``cuda`` runs the two steps on the card with
``torch.cuda.set_sync_debug_mode("warn")`` and holds the ``host_syncs``
counter to the number of synchronizing operations the card reports. Run it
there with

    python -m pytest --noconftest tests/test_torch_trace.py -q -m cuda
"""
import collections
import json
import sys
import threading
import warnings
from argparse import ArgumentParser, Namespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_garments_tpu_torch.utils import logging as log

S2_SPANS = {"step", "bundle", "project", "bin", "sync", "loss", "energies", "backward", "adam"}
S3_SPANS = {"step", "unet", "texels", "project", "bin", "sync", "loss", "backward", "adam"}
N_CAMS = 4
RES = 32
# What the card's sync debug mode finds in an eager step after the first:
# binning's read of its pair count a camera and Adam's two bias corrections
# a copy (once for the vertices, the net and the splats). Binning's
# constants, SSIM's window and the appearance net's FIR filters are copied
# once, at the first step.
EXPECTED_SYNCS = {"s2": N_CAMS + 2, "s3": 1 + 2 + 2}


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


def s2_case(device):
    """A ``seq`` step with the body on a 6×6 sheet seen by four 64² cameras:
    (step, its arguments)."""
    from gaussian_garments_tpu_torch.data.synthetic import make_scene
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2

    cams, verts, faces, _, colors = make_scene(n_cams=N_CAMS, nx=6, ny=6, width=64, height=64,
                                               device=device)
    v0 = verts + np.random.RandomState(0).randn(*verts.shape).astype(np.float32) * 0.01
    params, aux, binding, _ = MG.create_from_template(v0, faces, colors, max_sh_degree=0,
                                                      device=device)
    body_v = verts - np.array([0, 0, 0.0005], np.float32)
    mesh = MM.init_body(MM.create(v0, faces, device=device), body_v, faces,
                        np.arange(len(verts)) % len(faces))
    state = S2.init_state(params, aux, binding, mesh)
    step = S2.make_s2_step(_opt(), mode="seq", use_body=True)
    return step, (state, BatchedCameras.from_cameras(cams), torch.zeros(3, device=device),
                  1.6e-3, 1.6e-3)


def s3_case(device):
    """A ``full`` step on one 64² item of the sheet at texture 32, SH 1:
    (step, its arguments)."""
    from gaussian_garments_tpu_torch.data.synthetic import make_scene
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    cams, verts, faces, uvs, _ = make_scene(n_cams=1, nx=6, ny=6, width=64, height=64,
                                            device=device)
    bind, _ = AG.build_binding(uvs, faces, RES, device=device)
    n = bind.binding.shape[0]
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    splats = G.GaussianParams(
        xyz=torch.zeros(n, 3), features_dc=r(n, 1, 3) * 0.3, features_rest=r(n, 3, 3) * 0.05,
        scaling=r(n, 3) * 0.2 - 4.0, rotation=torch.tensor([[1.0, 0, 0, 0]]) + r(n, 4) * 0.2,
        opacity=r(n, 1) * 0.5 + 1.0)
    splats = G.GaussianParams(**{k: getattr(splats, k).to(device) for k in G.PARAM_NAMES})
    net = AvatarNet(RES, 1, generator=torch.Generator().manual_seed(1)).to(device)
    state = S3.init_state(net, splats)
    c = cams[0]
    t = lambda x: x.to(device)
    item = S3.S3Item(
        image=c.original_image[None], mask=c.gt_alpha_mask[None], bg=t(torch.rand(1, 3,
                                                                                   generator=g)),
        mesh_v=t(torch.as_tensor(verts))[None], ambient=t(torch.rand(1, 1, RES, RES,
                                                                     generator=g)),
        normal=t(torch.rand(1, 3, RES, RES, generator=g)),
        world_view=c.world_view_transform[None], full_proj=c.full_proj_transform[None],
        campos=c.camera_center[None], tanfovx=(c.tanfovx,), tanfovy=(c.tanfovy,),
        vis=torch.ones((1, n), device=device), width=64, height=64)
    step = S3.make_s3_step(net, Namespace(**{**vars(_opt()), "lr_init": 5e-4}), sh_degree=1)
    return step, (state, bind, t(torch.as_tensor(faces)), item)


CASES = {"s2": (s2_case, S2_SPANS), "s3": (s3_case, S3_SPANS)}


def test_span_off_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = log.span("step"), log.span("project")
    assert a is b
    with a:
        with b:
            log.count("host_syncs")
    assert log.records() == []
    assert log.counters() == {"host_syncs": 1}


def test_nested_spans_record_parents_and_self_times():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with log.span("step"):
                with log.span("loss"):
                    with log.span("sync"):
                        pass
                with log.span("adam"):
                    pass
    recs = log.records()
    assert [(r.name, r.parent, r.step) for r in recs] == [
        ("step", -1, 0), ("loss", 0, 0), ("sync", 1, 0), ("adam", 0, 0),
        ("step", -1, 1), ("loss", 4, 1), ("sync", 5, 1), ("adam", 4, 1)]
    assert all(r.t0_ns <= r.t1_ns for r in recs)
    for step in (0, 1):
        selfs = log.self_times(recs, steps={step})
        root = next(r for r in recs if r.step == step and r.parent < 0)
        assert set(selfs) == {"step", "loss", "sync", "adam"}
        assert all(v >= 0 for v in selfs.values())
        assert sum(selfs.values()) == root.t1_ns - root.t0_ns
    assert not torch.autograd.profiler._is_profiler_enabled
    assert log.span("step") is log.span("loss")


def test_count_adds_to_the_step_and_the_process():
    log.count("host_syncs", 2)
    log.enable()
    with log.span("step"):
        log.count("host_syncs", 3)
        log.count("composite_fwd.launches")
    with log.span("step"):
        log.count("host_syncs")
    log.disable()
    log.count("host_syncs")
    assert log.counters(0) == {"host_syncs": 3, "composite_fwd.launches": 1}
    assert log.counters(1) == {"host_syncs": 1}
    assert log.counters() == {"host_syncs": 7, "composite_fwd.launches": 1}
    assert [r.name for r in log.records()] == ["step", "step"]


def test_count_from_many_threads_loses_nothing():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        log.enable()
        with log.span("step"):
            threads = [threading.Thread(target=lambda: [log.count("host_syncs")
                                                        for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert log.counters() == log.counters(0) == {"host_syncs": 16 * 2000}


def test_span_stamp_is_on_the_trace_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with log.span("warm"):
            pass
        with log.span("twin"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    twin = next(e for e in trace["traceEvents"] if e.get("name") == "twin")
    rec = next(r for r in log.records() if r.name == "twin")
    ts_ns = twin["ts"] * 1e3 + trace["baseTimeNanoseconds"]
    assert abs(rec.t0_ns - ts_ns) < 1e6
    assert abs(rec.t1_ns - (ts_ns + twin["dur"] * 1e3)) < 1e6


def _syncs_in_a_step(case):
    """The counts of spans and host syncs of one step under the profiler."""
    step, args = case
    step(*args)                    # builds what the first call builds
    log.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step(*args)
    return log.records(), log.counters(0)


@pytest.mark.parametrize("stage", sorted(CASES))
def test_step_records_every_layer_span(stage):
    build, names = CASES[stage]
    recs, counts = _syncs_in_a_step(build(torch.device("cpu")))
    assert {r.name for r in recs} == names
    assert [r.name for r in recs if r.parent < 0] == ["step"]
    assert counts["host_syncs"] == EXPECTED_SYNCS[stage]


def _debug_syncs(step, args):
    """(the synchronizing operations the card reports in one call of
    ``step``, as (file:line, innermost open span)), the ``host_syncs`` counted
    in it)."""
    log.enable()
    before = log.counters().get("host_syncs", 0)
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            open_spans = [r.name for r in log.records() if r.t1_ns is None]
            found.append((f"{filename}:{lineno}", open_spans[-1] if open_spans else None))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found, log.counters().get("host_syncs", 0) - before


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(CASES))
def test_host_syncs_match_the_cards_sync_debug(stage):
    """Every synchronizing operation that the card reports inside the
    program's eager step is one ``host_syncs`` count in a ``sync`` span; the
    s2 and s3 steps' graphs replay with none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from gaussian_garments_tpu_torch import pin_full_f32

    pin_full_f32()
    dev = torch.device("cuda", 0)
    step, args = CASES[stage][0](dev)
    eager = getattr(step, "eager", step)
    eager(*args)
    torch.cuda.synchronize()
    found, counted = _debug_syncs(eager, args)
    assert found
    assert collections.Counter(loc for loc, s in found if s != "sync") == {}
    assert counted == len(found) == EXPECTED_SYNCS[stage], collections.Counter(found)
    step(*args)                    # captures
    torch.cuda.synchronize()
    replays = log.counters().get(f"{stage}_graph.replay", 0)
    found, counted = _debug_syncs(step, args)
    assert found == [] and counted == 0
    assert log.counters()[f"{stage}_graph.replay"] == replays + 1
