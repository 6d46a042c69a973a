"""What the s3 step's CUDA graph (``training/s3``, ``training/graph``) rests
on, held on the CPU: the step run on the graph's inputs (static copies, the
per-step scalars as float64 tensors) equals the eager step; the key follows
what the step sees; the CPU, data-parallel and visibility-computing steps
stay eager; the FIR filters that the appearance net no longer copies each
call equal the ones it copied; both Adams give the same numbers with their
bias corrections passed in; binning's 32-bit keys give the int64 table, at
s2's and s3's splat counts; and the grouped clone keeps each tensor. The
graph itself runs only on the card: ``tests/test_torch_kernel_cuda.py``
holds it against the eager step there.

The suite runs six test processes on the CPU at once; this file runs torch on
two threads, since more threads per process only contend.
"""
from argparse import ArgumentParser, Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gaussian_garments_tpu_torch.utils import logging as log

RES = 32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    log.disable()
    log.reset()
    yield
    log.disable()
    log.reset()


def _args():
    from gaussian_garments_tpu_torch.config import OptimizationParams

    parser = ArgumentParser()
    return Namespace(**{**vars(OptimizationParams(parser).extract(parser.parse_args([]))),
                        "lr_init": 5e-4})


def s3_graph_case(device, n_items=2, width=64, height=64, res=RES, dense=False):
    """A 6×6 sheet at texture ``res``, SH 1, its state and net, and a
    function ``item(i)`` giving its i-th batch of ``n_items`` items: each
    item a camera of its own focal length, with the sheet's ground truth, a
    background and the visibility all ones. (net, state, bind, faces,
    item)."""
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    verts, faces, uvs = syn.make_cloth_template(6, 6)
    colors = syn.face_checker_colors(faces, verts)
    n_ring = 8
    ring = [syn.make_camera_ring(n_ring, fx=60.0 * (1.0 + 0.07 * i), width=width,
                                 height_px=height, device=device)[i] for i in range(n_ring)]
    cams = syn.render_ground_truth(ring, verts, faces, colors)
    bind, _ = AG.build_binding(uvs, faces, res, dense=dense, device=device)
    n = bind.binding.shape[0]
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    splats = G.GaussianParams(
        xyz=torch.zeros(n, 3), features_dc=r(n, 1, 3) * 0.3, features_rest=r(n, 3, 3) * 0.05,
        scaling=r(n, 3) * 0.2 - 3.0, rotation=torch.tensor([[1.0, 0, 0, 0]]) + r(n, 4) * 0.2,
        opacity=r(n, 1) * 0.5 + 1.0)
    splats = G.GaussianParams(**{k: getattr(splats, k).to(device) for k in G.PARAM_NAMES})
    net = AvatarNet(res, 1, generator=torch.Generator().manual_seed(1)).to(device)
    v = torch.as_tensor(verts, device=device)
    amb = torch.rand(1, 1, res, res, generator=g).to(device)
    nrm = torch.rand(1, 3, res, res, generator=g).to(device)

    def item(i):
        cs = [cams[(3 * i + k) % n_ring] for k in range(n_items)]
        stack = lambda f: torch.stack([f(c) for c in cs])
        return S3.S3Item(
            image=stack(lambda c: c.original_image), mask=stack(lambda c: c.gt_alpha_mask),
            bg=torch.rand(n_items, 3, generator=torch.Generator().manual_seed(i)).to(device),
            mesh_v=(v + 0.002 * i).expand(n_items, -1, -1).contiguous(),
            ambient=amb.expand(n_items, -1, -1, -1).contiguous(),
            normal=nrm.expand(n_items, -1, -1, -1).contiguous(),
            world_view=stack(lambda c: c.world_view_transform),
            full_proj=stack(lambda c: c.full_proj_transform),
            campos=stack(lambda c: c.camera_center),
            tanfovx=tuple(c.tanfovx for c in cs), tanfovy=tuple(c.tanfovy for c in cs),
            vis=torch.ones((n_items, n), device=device), width=width, height=height)

    return net, S3.init_state(net, splats), bind, torch.as_tensor(faces, device=device), item


def _leaves(state):
    from gaussian_garments_tpu_torch.models import gaussian as G

    out = {f"net.{k}": v for k, v in state.net_params.items()}
    out.update((f"net_mu.{k}", v) for k, v in state.net_adam.mu.items())
    for name, p in (("splats", state.splats), ("splat_mu", state.splat_adam.mu),
                    ("splat_nu", state.splat_adam.nu)):
        out.update((f"{name}.{k}", getattr(p, k)) for k in G.PARAM_NAMES)
    return out


def _change_gaps(new, ref, start):
    """Per moved parameter leaf, the harness's change gap: |‖new − start‖ −
    ‖ref − start‖| / ‖ref − start‖."""
    gaps = {}
    for k in ref:
        if k.startswith(("net.", "splats.")):
            b = float(torch.linalg.norm((ref[k] - start[k]).double()))
            if b > 0:
                gaps[k] = abs(float(torch.linalg.norm((new[k] - start[k]).double())) - b) / b
    return gaps


@pytest.mark.parametrize("train_gaussians", [False, True], ids=["pre_train", "full"])
def test_step_on_the_graphs_inputs_equals_the_eager_step(train_gaussians):
    """``_graph_args`` on copies of the inputs and the scalars as float64
    tensors, as the graph reads them, against the eager step, for two
    steps on batches of two items of distinct focal lengths; the outputs go
    through ``_graph_outputs`` and ``_graph_result`` as a replay's do. With
    the item's own ``tanfov`` floats the first step is the eager step bit for
    bit; with the scalars' (the focal lengths then round once more, by an
    ulp) the losses agree to 1e-6 of their sum and each leaf's change to 1e-4 (2.4e-6
    read; Adam's eps of 1e-15 turns a rounding-level gradient into a step).
    The caller's state is not written."""
    from gaussian_garments_tpu_torch.training import s3 as S3

    net, state, bind, faces, item = s3_graph_case(torch.device("cpu"))
    step = S3.make_s3_step(net, _args(), sh_degree=1, train_gaussians=train_gaussians)
    kept = {k: v.clone() for k, v in S3._graph_inputs(state, bind, faces, item(0), True).items()}

    def on_graph_inputs(s, it, float_tanfov=False):
        copies = {k: v.clone() for k, v in
                  S3._graph_inputs(s, bind, faces, it, train_gaussians).items()}
        moments = [k for k in copies if k.startswith(("splat_mu.", "splat_nu."))]
        assert len(moments) == (12 if train_gaussians else 0)
        scalars = torch.tensor(S3._graph_scalars(s, it), dtype=torch.float64)
        args = S3._graph_args(s, bind, it, copies, scalars, train_gaussians)
        if float_tanfov:
            args[3].tanfovx, args[3].tanfovy = it.tanfovx, it.tanfovy
        new, loss = step.eager(*args)
        out = {k: v.clone() for k, v in S3._graph_outputs(new, loss, train_gaussians).items()}
        return S3._graph_result(s, out, train_gaussians)

    eager_s, graph_s = state, state
    for i in range(2):
        it = item(i)
        assert len(set(it.tanfovx)) == 2
        if i == 0:
            same_s, same_loss = on_graph_inputs(state, it, float_tanfov=True)
        graph_s, g_loss = on_graph_inputs(graph_s, it)
        eager_s, e_loss = step.eager(eager_s, bind, faces, it)
        if i == 0:
            assert list(same_loss) == list(e_loss)
            assert all(torch.equal(same_loss[k], e_loss[k]) for k in e_loss)
            got, want = _leaves(same_s), _leaves(eager_s)
            assert list(got) == list(want)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert list(g_loss) == list(e_loss)
        total = float(sum(e_loss.values()))
        for k in e_loss:
            assert abs(float(g_loss[k]) - float(e_loss[k])) <= 1e-6 * abs(total), k
        assert graph_s.net_adam.step == eager_s.net_adam.step == i + 1
        assert graph_s.splat_adam.step == eager_s.splat_adam.step == (i + 1 if train_gaussians
                                                                      else 0)
        assert graph_s.iteration == eager_s.iteration == i + 1
        if not train_gaussians:
            assert graph_s.splats is state.splats
    gaps = _change_gaps(_leaves(graph_s), _leaves(eager_s), _leaves(state))
    assert len(gaps) >= 20 and max(gaps.values()) <= 1e-4
    for k, v in S3._graph_inputs(state, bind, faces, item(0), True).items():
        assert torch.equal(v, kept[k]), k


def test_graph_key_follows_what_the_step_sees():
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    cpu = torch.device("cpu")
    net, state, bind, faces, item = s3_graph_case(cpu)
    key = lambda net, state, bind, it, tg=True: S3._graph_key(
        net, it, S3._graph_inputs(state, bind, faces, it, tg), tg)
    base = key(net, state, bind, item(0))
    moved = state.replace(net_params={k: v + 0.01 for k, v in state.net_params.items()})
    assert key(net, moved, bind, item(1)) == base
    bf16 = AvatarNet(RES, 1, act_dtype=torch.bfloat16)
    _, _, dense_bind, _, _ = s3_graph_case(cpu, dense=True)
    n_dense = dense_bind.binding.shape[0]
    dense_state = S3.init_state(net, G.GaussianParams(**{
        k: torch.zeros((n_dense, *getattr(state.splats, k).shape[1:])) for k in G.PARAM_NAMES}))
    dense_item = item(0)
    dense_item.vis = torch.ones((2, n_dense))
    _, _, _, _, one = s3_graph_case(cpu, n_items=1)
    _, _, _, _, wide = s3_graph_case(cpu, width=96)
    keys = {base, key(net, state, bind, item(0), tg=False), key(bf16, state, bind, item(0)),
            key(net, dense_state, dense_bind, dense_item), key(net, state, bind, one(0)),
            key(net, state, bind, wide(0))}
    assert len(keys) == 6


def test_cpu_group_and_computed_visibility_steps_stay_eager(tmp_path):
    """On the CPU, and with a ``group`` (one gloo rank here), the step runs
    eagerly: no capture, no replay, and binning and both Adams copy what
    they read. On the card, only a step without a ``group`` whose items
    carry their visibility replays."""
    from gaussian_garments_tpu_torch.parallel import Group
    from gaussian_garments_tpu_torch.training import s3 as S3

    net, state, bind, faces, item = s3_graph_case(torch.device("cpu"), n_items=1)
    log.enable()
    step = S3.make_s3_step(net, _args(), sh_degree=1)
    state, _ = step(state, bind, faces, item(0))
    no_vis = item(1)
    no_vis.vis = None
    state, _ = step(state, bind, faces, no_vis)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        grouped = S3.make_s3_step(net, _args(), sh_degree=1, group=Group(0, 1, "gloo"))
        state, _ = grouped(state, bind, faces, item(2))
    finally:
        dist.destroy_process_group()
    counts = log.counters()
    assert "s3_graph.capture" not in counts and "s3_graph.replay" not in counts
    assert "replay" not in {r.name for r in log.records()}
    # binning's pair count, and each Adam's two bias corrections
    assert all(log.counters(i)["host_syncs"] >= 1 + 2 + 2 for i in range(3))
    assert state.iteration == 3

    card = SimpleNamespace(is_cuda=True)
    on_card = SimpleNamespace(image=card, vis=card)
    assert S3._runs_as_graph(on_card, None)
    assert not S3._runs_as_graph(on_card, Group(0, 1, "nccl"))
    assert not S3._runs_as_graph(SimpleNamespace(image=card, vis=None), None)
    assert not S3._runs_as_graph(SimpleNamespace(image=torch.zeros(1), vis=card), None)


def _todays_upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """``styleunet.upfirdn2d`` as it was, copying its filter at each call."""
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    n, c, h, w = x.shape
    kflip = torch.as_tensor(np.ascontiguousarray(kernel[::-1, ::-1]), dtype=x.dtype,
                            device=x.device)
    weight = kflip[None, None].expand(c, 1, *kflip.shape).contiguous()
    if up > 1:
        xu = x.new_zeros((n, c, h * up, w * up))
        xu[:, :, ::up, ::up] = x
        x = xu
    return F.conv2d(F.pad(x, pad), weight, stride=down, groups=c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["up", "down", "haar"])
def test_cached_fir_filter_equals_todays(mode, dtype):
    from gaussian_garments_tpu_torch.models import styleunet as SU

    x = torch.randn(2, 5, 12, 12, generator=torch.Generator().manual_seed(0)).to(dtype)
    k = SU.make_kernel(SU.BLUR)
    p = k.shape[0] - 2
    if mode == "up":
        calls = [(k * 4, dict(up=2, pad=((p + 1) // 2 + 1, p // 2)))]
    elif mode == "down":
        calls = [(k, dict(down=2, pad=((p + 1) // 2, p // 2)))]
    else:
        ll, lh, _, _ = SU._haar_kernels()
        calls = [(ll, dict(down=2)), (-lh, dict(up=2, pad=(1, 0, 1, 0)))]
    for kernel, kw in calls:
        want = _todays_upfirdn2d(x, kernel, **kw)
        got = SU.upfirdn2d(x, kernel, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        # made once: a second call copies nothing and counts no sync
        before = log.counters().get("host_syncs", 0)
        assert torch.equal(SU.upfirdn2d(x, kernel, **kw), want)
        assert log.counters().get("host_syncs", 0) == before


def test_adams_with_their_bias_corrections_passed_equal_their_defaults():
    """``tree_adam_step`` and ``G.adam_step`` bit for bit, with ``bcs`` as
    the float32 host pair and as the graph's float64 scalars."""
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.adam import (bias_corrections, tree_adam_init,
                                                         tree_adam_step)

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    params = {"a": r(7, 3), "b": r(5)}
    splats = G.GaussianParams(xyz=r(6, 3), features_dc=r(6, 1, 3), features_rest=r(6, 3, 3),
                              scaling=r(6, 3), rotation=r(6, 4), opacity=r(6, 1))
    lrs = {"xyz": 1e-3, "features_dc": 2e-3, "features_rest": 1e-4, "scaling": 5e-3,
           "rotation": 1e-3, "opacity": 0.05}
    t_state, s_state = tree_adam_init(params), G.adam_init(splats)
    for _ in range(3):
        t_grads = {k: r(*v.shape) for k, v in params.items()}
        s_grads = G.GaussianParams(**{k: r(*getattr(splats, k).shape) for k in G.PARAM_NAMES})
        t_want = tree_adam_step(params, t_grads, t_state, 5e-4)
        s_want = G.adam_step(splats, s_grads, s_state, lrs)
        bcs = bias_corrections(t_state.step + 1)
        as_scalars = tuple(torch.tensor([float(b) for b in bcs], dtype=torch.float64))
        for passed in (bcs, as_scalars):
            t_got = tree_adam_step(params, t_grads, t_state, 5e-4, bcs=passed)
            s_got = G.adam_step(splats, s_grads, s_state, lrs, bcs=passed)
            assert t_got[1].step == t_want[1].step and s_got[1].step == s_want[1].step
            for got, want in ((t_got[0], t_want[0]), (t_got[1].mu, t_want[1].mu),
                              (t_got[1].nu, t_want[1].nu)):
                assert all(torch.equal(got[k], want[k]) for k in want)
            for got, want in ((s_got[0], s_want[0]), (s_got[1].mu, s_want[1].mu),
                              (s_got[1].nu, s_want[1].nu)):
                assert all(torch.equal(getattr(got, k), getattr(want, k))
                           for k in G.PARAM_NAMES)
        params, t_state = t_want
        splats, s_state = s_want


@pytest.mark.parametrize("n", [10_630, 262_144], ids=["s2_splats", "s3_texels"])
def test_padded_binning_with_32_bit_keys_equals_the_int64_table(n, monkeypatch):
    """At the cells' splat counts and 940×1280 frames (``num_tiles·N`` <
    2³¹, so int32 keys), the padded layout with 32-bit keys gives the exact
    table sorted with int64 keys."""
    from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene
    from gaussian_garments_tpu_torch.ops import tiles

    w, h, side = 940, 1280, 6
    proj = make_cull_scene(n, 3, width=w, height=h, device="cpu")
    tx, ty = tiles.tile_grid(w, h)
    assert tiles._key_dtype(tx * ty, n) == torch.int32
    assert tiles._key_dtype(188 * 128, 262_144) == torch.int64      # 3004×4092 frames
    ell = tiles.ellipse(proj)
    padded = tiles._bin(proj, ell, tx, ty, side, padded=True)
    monkeypatch.setattr(tiles, "_key_dtype", lambda num_tiles, n: torch.int64)
    exact = tiles._bin(proj, ell, tx, ty, side)
    total = int(exact.ranges[-1])
    assert total == exact.pair_splat.shape[0] > n
    assert padded.pair_splat.shape[0] == n * side * side
    assert torch.equal(padded.ranges, exact.ranges)
    assert torch.equal(padded.pair_splat[:total], exact.pair_splat)
    assert int(padded.n_clipped) == int(exact.n_clipped)


def test_clone_into_one_buffer_keeps_each_tensor():
    from gaussian_garments_tpu_torch.training import graph

    src = {"a": torch.arange(6.0).reshape(2, 3), "i": torch.arange(4), "s": torch.tensor(2.5),
           "b": torch.ones(3, 1, 2)}
    out = graph.clone_into_one_buffer(src)
    assert list(out) == list(src)
    for k, v in src.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v)
        assert out[k].data_ptr() != v.data_ptr()
    base = out["a"].untyped_storage().data_ptr()
    assert all(out[k].untyped_storage().data_ptr() == base for k in ("s", "b"))
    src["a"].add_(1.0)
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
