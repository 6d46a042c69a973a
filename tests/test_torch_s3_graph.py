"""What the s3 step's CUDA graph (``training/s3``, ``training/graph``) rests
on, held on the CPU: the walker's round trip, scalars and key; the step run
on the graph's inputs (static copies, the per-step scalars as float64
tensors) equals the eager step; the key follows what the step sees; the
CPU, data-parallel and visibility-computing steps stay eager; the FIR
filters that the appearance net no longer copies each call equal the ones
it copied; both Adams give the same numbers with their bias corrections
passed in; binning's 32-bit keys give the int64 table, at s2's and s3's
splat counts; and the grouped clone keeps each tensor. The
graph itself runs only on the card: ``tests/test_torch_kernel_cuda.py``
holds it against the eager step there.

The suite runs six test processes on the CPU at once; this file runs torch on
two threads, since more threads per process only contend.
"""
import dataclasses
from argparse import ArgumentParser, Namespace
from types import SimpleNamespace
from typing import NamedTuple, Optional

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


def graph_path_on_the_cpu(monkeypatch, keep_floats=False) -> list:
    """Both trainers' steps take their graph path on the CPU, with
    ``graph.StepGraph`` replaced by a stand-in that runs the step uncaptured
    at each call, on static copies of its inputs, with its floats as 0-d
    float64 views of one vector (``keep_floats``: the floats themselves, as
    the first call gave them), and returns the outputs cloned into one
    buffer a dtype and rebuilt, as a replay does. Returns the stand-ins
    built, one a key."""
    from gaussian_garments_tpu_torch.training import graph
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.training import s3 as S3

    built = []

    class OnCopies:
        def __init__(self, name, fn, args, pool=None):
            tensors, floats, _ = graph.flatten(args)
            self.inputs = [t.clone() for t in tensors]
            self.scalars = torch.zeros(len(floats), dtype=torch.float64)
            self.fn, self.static = fn, graph.rebuild(
                args, self.inputs, floats if keep_floats else self.scalars.unbind())
            self.graph = SimpleNamespace(pool=lambda: None)
            built.append(self)

        def __call__(self, tensors, floats):
            torch._foreach_copy_(self.inputs, list(tensors))
            self.scalars.copy_(torch.tensor(floats, dtype=torch.float64))
            out = self.fn(*self.static)
            return graph.rebuild(out, graph.clone_into_one_buffer(graph.flatten(out)[0]), ())

    monkeypatch.setattr(graph, "StepGraph", OnCopies)
    monkeypatch.setattr(S2, "_runs_as_graph", lambda *args: True)
    monkeypatch.setattr(S3, "_runs_as_graph", lambda *args: True)
    return built


@pytest.mark.parametrize("train_gaussians", [False, True], ids=["pre_train", "full"])
def test_step_on_the_graphs_inputs_equals_the_eager_step(train_gaussians, monkeypatch):
    """The step on its graph path (``graph_path_on_the_cpu``: the walker's
    static copies, the per-step floats as float64 tensors, the outputs
    cloned and rebuilt as a replay's are) against the eager step, for two
    steps on batches of two items of distinct focal lengths, through one
    key. With the floats themselves (the cameras' ``tanfov``, the bias
    corrections) the first step is the eager step bit for bit; with the
    scalars' (the focal lengths then round once more, by an ulp) the losses
    agree to 1e-6 of their sum and each leaf's change to 1e-4 (2.4e-6 read;
    Adam's eps of 1e-15 turns a rounding-level gradient into a step). The
    graph copies in the splat moments only with ``train_gaussians``. The
    caller's state is not written."""
    from gaussian_garments_tpu_torch.training import graph
    from gaussian_garments_tpu_torch.training import s3 as S3

    net, state, bind, faces, item = s3_graph_case(torch.device("cpu"))
    make = lambda: S3.make_s3_step(net, _args(), sh_degree=1, train_gaussians=train_gaussians)
    kept = [t.clone() for t in graph.flatten((state, bind, faces, item(0)))[0]]
    inputs = graph.flatten(make().graph_call(state, bind, faces, item(0))[1])[0]
    moments = [t for p in (state.splat_adam.mu, state.splat_adam.nu) for t in vars(p).values()]
    assert sum(any(t is m for m in moments) for t in inputs) == (12 if train_gaussians else 0)

    graph_path_on_the_cpu(monkeypatch, keep_floats=True)
    same_s, same_loss = make()(state, bind, faces, item(0))
    built = graph_path_on_the_cpu(monkeypatch)
    step = make()
    eager_s, graph_s = state, state
    for i in range(2):
        it = item(i)
        assert len(set(it.tanfovx)) == 2
        graph_s, g_loss = step(graph_s, bind, faces, it)
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
    assert len(built) == 1
    gaps = _change_gaps(_leaves(graph_s), _leaves(eager_s), _leaves(state))
    assert len(gaps) >= 20 and max(gaps.values()) <= 1e-4
    now = graph.flatten((state, bind, faces, item(0)))[0]
    assert len(now) == len(kept) and all(torch.equal(a, b) for a, b in zip(now, kept))


def test_graph_key_follows_what_the_step_sees():
    """The key of a step's graph (its arguments' key and what the step adds)
    differs by train_gaussians, the net's activation dtype, the dense
    layout, the item count and the image size, and stays when only values
    move: the weights, the item's cameras and the host's step counts."""
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import graph
    from gaussian_garments_tpu_torch.training import s3 as S3

    cpu = torch.device("cpu")
    net, state, bind, faces, item = s3_graph_case(cpu)

    def key(net, state, bind, it, tg=True):
        step = S3.make_s3_step(net, _args(), sh_degree=1, train_gaussians=tg)
        _, args, extra = step.graph_call(state, bind, faces, it)
        return extra, graph.flatten(args)[2]

    base = key(net, state, bind, item(0))
    moved = state.replace(net_params={k: v + 0.01 for k, v in state.net_params.items()},
                          net_adam=state.net_adam._replace(step=7),
                          splat_adam=state.splat_adam._replace(step=3), iteration=9)
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

    src = [torch.arange(6.0).reshape(2, 3), torch.arange(4), torch.tensor(2.5), torch.ones(3, 1, 2)]
    out = graph.clone_into_one_buffer(src)
    assert len(out) == len(src)
    for o, v in zip(out, src):
        assert o.dtype == v.dtype and torch.equal(o, v)
        assert o.data_ptr() != v.data_ptr()
    base = out[0].untyped_storage().data_ptr()
    assert all(out[i].untyped_storage().data_ptr() == base for i in (2, 3))
    src[0].add_(1.0)
    assert torch.equal(out[0], torch.arange(6.0).reshape(2, 3))


class _Pair(NamedTuple):
    weight: torch.Tensor
    layers: int


@dataclasses.dataclass
class _Tree:
    pair: _Pair
    named: dict
    gap: Optional[torch.Tensor]
    count: int
    flag: bool
    rates: tuple


@dataclasses.dataclass
class _Grown(_Tree):
    added: torch.Tensor = None


def test_walker_round_trip_scalars_key_and_an_added_field():
    """``graph.flatten`` and ``graph.rebuild`` on a dataclass holding a
    NamedTuple, a dict, a None, an int, a bool and a tuple of floats: the
    round trip is the identity; the floats come out in order and go back as
    0-d float64 views of one vector; the ints and bools are in the key, and
    moved values are not; a tensor field added to the dataclass is an input
    with no other edit."""
    from gaussian_garments_tpu_torch.training import graph

    w, a, b = torch.ones(2, 3), torch.zeros(4), torch.arange(3)
    tree = _Tree(pair=_Pair(w, 2), named={"a": a, "b": b}, gap=None, count=5, flag=True,
                 rates=(0.5, 0.25))
    tensors, floats, key = graph.flatten(tree)
    assert [id(t) for t in tensors] == [id(w), id(a), id(b)] and floats == [0.5, 0.25]
    back = graph.rebuild(tree, tensors, floats)
    assert back == tree and type(back.pair) is _Pair and list(back.named) == ["a", "b"]
    assert back.pair.weight is w and back.gap is None

    vector = torch.tensor(floats, dtype=torch.float64)
    on_scalars = graph.rebuild(tree, tensors, vector.unbind())
    assert all(r.ndim == 0 and r.dtype == torch.float64 for r in on_scalars.rates)
    assert [float(r) for r in on_scalars.rates] == floats
    vector[1] = 2.0
    assert float(on_scalars.rates[1]) == 2.0

    moved = dataclasses.replace(tree, pair=_Pair(w + 1, 2), named={"a": a - 1, "b": b + 1},
                                rates=(0.75, 0.125))
    assert graph.flatten(moved)[2] == key
    for changed in (dataclasses.replace(tree, count=6), dataclasses.replace(tree, flag=False),
                    dataclasses.replace(tree, pair=_Pair(w, 3)),
                    dataclasses.replace(tree, gap=torch.zeros(1)),
                    dataclasses.replace(tree, named={"a": a, "b": b[:2]})):
        assert graph.flatten(changed)[2] != key

    c = torch.full((2,), 3.0)
    grown = _Grown(**vars(tree), added=c)
    assert graph.flatten(grown)[0][-1] is c
    assert graph.rebuild(grown, *graph.flatten(grown)[:2]).added is c
