"""The CUDA splat compositor on the card, forward and backward, held against
its plain PyTorch versions and the exact oracle; the probe kernels against
their plain versions. Every test here needs an
NVIDIA GPU with nvcc and skips without one; run them on the card with

    python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q

The backward kernel sums with atomics in an order that changes from run to
run: it is held to its plain version at 1e-4 × max|plain| per gradient
component (2e-4 on a saturated tile), the bounds ``tests/test_pallas.py``
holds the TPU kernel to.
"""
import numpy as np
import pytest
import torch

from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene, make_splat_scene
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
from gaussian_garments_tpu_torch.utils.camera import make_camera

pytestmark = pytest.mark.cuda

H = W = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from gaussian_garments_tpu_torch import pin_full_f32
    pin_full_f32()
    return torch.device("cuda", 0)


def _proj(dev, n, n_wide=0, seed=0, max_opacity=1.0):
    s = make_splat_scene(n, seed, n_wide=n_wide, max_opacity=max_opacity)
    cam = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=300, fy=300,
                      cx=W / 2, cy=H / 2, width=W, height=H, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in s.items()}
    return project_gaussians(
        t["means"], cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=W, image_height=H, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t["scales"], rotations=t["rots"], shs=t["shs"], opacities=t["opacity"],
        sh_degree=0)


def _both(proj):
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    k = tiles.composite_tiles(pairs, image_height=H, image_width=W)
    p = tiles.composite_tiles_plain(pairs, image_height=H, image_width=W)
    torch.cuda.synchronize()
    return pairs, k, p


@pytest.mark.parametrize("n_wide", [0, 8])
def test_kernel_matches_plain(dev, n_wide):
    """Same gates, same serial order, -fmad=false: agreement to 1e-4 (image,
    alpha), 1e-3 × depth range (depth), and the same last pair."""
    proj = _proj(dev, 20000, n_wide=n_wide)
    pairs, k, p = _both(proj)
    if n_wide:
        assert int(pairs.n_clipped) > 0
    torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(k.alpha, p.alpha, atol=1e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3 * drange, rtol=0)
    assert (k.last_pair == p.last_pair).float().mean() > 0.999


def test_kernel_matches_oracle(dev):
    """No clipping, and opacities ≤ 0.35 so that no splat reaches α ≥ 1/255
    outside its 3σ tile rect (see ``make_splat_scene``): the kernel equals the
    per-pixel oracle. The oracle sums log T in another order, so the T ≥ 1e-4
    gate can flip on a pixel, which moves its alpha by at most 1e-4:
    tolerance 2e-4."""
    proj = _proj(dev, 20000, max_opacity=0.35)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    img, depth, alpha, aux = tiles.rasterize_tiles(proj, image_height=H, image_width=W, bg=bg)
    assert int(aux["n_clipped"]) == 0
    ir, dr, ar = rasterize_reference(proj, image_height=H, image_width=W, bg=bg,
                                     pixel_chunk=4096)
    torch.testing.assert_close(img, ir, atol=2e-4, rtol=0)
    torch.testing.assert_close(alpha, ar, atol=2e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(depth, dr, atol=1e-3 * drange, rtol=0)


def test_launch_counter_and_no_backward(dev):
    """One forward launch per composite, and the backward goes through the
    backward kernel (it once raised; now it launches exactly once)."""
    proj = _proj(dev, 2000)
    before = tiles.launches()
    feats = tiles.bin_pairs(proj, image_width=W, image_height=H)
    feats = feats._replace(feats=feats.feats.clone().requires_grad_(True))
    out = tiles.composite_tiles(feats, image_height=H, image_width=W)
    assert tiles.launches()["composite_fwd"] == before["composite_fwd"] + 1
    out.color.sum().backward()
    assert tiles.launches()["composite_bwd"] == before["composite_bwd"] + 1
    assert torch.isfinite(feats.feats.grad).all()


def test_kernel_rejects_wrong_dtype(dev):
    pairs = tiles.bin_pairs(_proj(dev, 100), image_width=W, image_height=H)
    with pytest.raises(ValueError):
        tiles.composite_tiles_cuda(pairs._replace(ranges=pairs.ranges.long()),
                                   image_height=H, image_width=W)


def _cotangents(dev, seed=0):
    g = np.random.RandomState(seed).randn(5, H, W).astype(np.float32)
    g = torch.as_tensor(g, device=dev)
    return g[:3].contiguous(), g[3:4].contiguous(), g[4:5].contiguous()


def backward_error(pairs, out, cot):
    """Per-component max |kernel − plain| over max |plain| (columns 0-9)."""
    kw = dict(image_height=H, image_width=W)
    k = tiles.composite_tiles_backward_cuda(pairs, out.final_logt, out.last_pair, *cot, **kw)
    p = tiles.composite_tiles_backward_plain(pairs, out.final_logt, out.last_pair, *cot, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert torch.equal(k[:, 10:], torch.zeros_like(k[:, 10:]))
    scale = p[:, :10].abs().amax(dim=0).clamp(min=1e-30)
    return float(((k - p)[:, :10].abs().amax(dim=0) / scale).max())


@pytest.mark.parametrize("n_wide,max_opacity", [(0, 0.35), (0, 1.0), (8, 1.0)])
def test_backward_kernel_matches_plain(dev, n_wide, max_opacity):
    proj = _proj(dev, 20000, n_wide=n_wide, max_opacity=max_opacity)
    pairs, out, _ = _both(proj)
    assert backward_error(pairs, out, _cotangents(dev)) <= 1e-4


def test_backward_kernel_matches_plain_on_saturated_tile(dev):
    n = 600
    rng = np.random.RandomState(1)
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.randn(n, 2).astype(np.float32) * 0.015
    means[:, 2] = np.linspace(-0.4, 0.4, n)
    t = lambda x: torch.as_tensor(x, device=dev)
    cam = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=300, fy=300,
                      cx=W / 2, cy=H / 2, width=W, height=H, device=dev)
    proj = project_gaussians(
        t(means), cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=W, image_height=H, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t(np.exp(rng.randn(n, 3).astype(np.float32) * 0.2 - 3.4)),
        rotations=t(rng.randn(n, 4).astype(np.float32)),
        shs=t(rng.randn(n, 1, 3).astype(np.float32) * 0.3),
        opacities=t(np.full((n,), 0.97, np.float32)), sh_degree=0)
    pairs, out, _ = _both(proj)
    assert int((pairs.ranges[1:] - pairs.ranges[:-1]).max()) > 256
    assert float(out.alpha.max()) > 0.9999
    assert backward_error(pairs, out, _cotangents(dev, 1)) <= 2e-4


def test_kernels_match_plain_on_cull_scene(dev):
    """Splats aimed at the culls (``make_cull_scene``): opacity 0.95-0.99
    contours past 3σ, centres on warp corners, long thin and bad-conic
    splats. The forward matches its plain version as above; the backward to
    1e-4 × max per component."""
    proj = make_cull_scene(3000, 4, width=W, height=H, device=dev)
    pairs, k, p = _both(proj)
    assert bool((tiles.warp_extents(tiles.ellipse(proj))[:, 0] < 0).any())
    torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(k.alpha, p.alpha, atol=1e-4, rtol=0)
    drange = float(proj.depth.max() - proj.depth.min())
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3 * drange, rtol=0)
    assert (k.last_pair == p.last_pair).float().mean() > 0.999
    assert backward_error(pairs, k, _cotangents(dev, 3)) <= 1e-4


def test_backward_kernel_matches_oracle_autograd(dev):
    """Opacity ≤ 0.35: the kernel's gradients of the splat features equal
    torch autograd through the exact per-pixel oracle to 1e-4 × max."""
    proj = _proj(dev, 3000, max_opacity=0.35)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    target = torch.as_tensor(np.random.RandomState(2).rand(3, H, W).astype(np.float32),
                             device=dev)
    grads = []
    for raster in ("kernel", "oracle"):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (proj.means2d, proj.conic, proj.rgb, proj.opacity, proj.depth)]
        p = proj._replace(means2d=leaves[0], conic=leaves[1], rgb=leaves[2],
                          opacity=leaves[3], depth=leaves[4])
        if raster == "kernel":
            img, depth, alpha, _ = tiles.rasterize_tiles(p, image_height=H, image_width=W, bg=bg)
        else:
            img, depth, alpha = rasterize_reference(p, image_height=H, image_width=W, bg=bg,
                                                    pixel_chunk=4096)
        loss = ((img - target) ** 2).mean() + 0.1 * depth.mean() + 0.05 * (alpha ** 2).mean()
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


# ---------------------------------------------------------------------------
# the probe kernels (``csrc/probe_gather.cu``, ``csrc/probe_composite.cu``),
# each against its plain version with the tolerance its entry states
# ---------------------------------------------------------------------------

def _held(entry):
    from gaussian_garments_tpu_torch.probes.common import check

    before = entry.wrapper.launches
    err, ok = check(entry)
    assert ok, (entry.name, entry.row, err, entry.tolerance)
    assert entry.wrapper.launches == before + 1


@pytest.mark.parametrize("row", ["3", "4C", "5", "4A", "4B"])
def test_gather_probe_kernels_match_plain(dev, row):
    from gaussian_garments_tpu_torch.probes import gather

    for e in gather.entries(dev, rows=(row,)):
        _held(e)


def test_composite_probe_kernels_match_plain(dev):
    from gaussian_garments_tpu_torch.probes import composite_null, grid_overhead
    from gaussian_garments_tpu_torch.probes.worklist import build_worklist

    pairs = tiles.bin_pairs(_proj(dev, 20000), image_width=W, image_height=H)
    for e in composite_null.entries(pairs, H, W):
        _held(e)
    for e in grid_overhead.entries(pairs, build_worklist(pairs.ranges)):
        _held(e)


@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("row", ["3", "4C", "5"])
def test_gather_cluster_kernel_exact_at_every_size(dev, row, cluster):
    """``flat_cluster`` at every cluster size it is built for equals
    ``table[idx]`` bit for bit, and its launches count."""
    from gaussian_garments_tpu_torch.probes import gather

    table, idx = gather.make_inputs(dev)[row]
    before = gather.gather_flat_cluster_cuda.launches
    got = gather.gather_flat_cluster_cuda(table, idx, blk=gather.FLAT_ROWS[row][3],
                                          cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_flat_plain(table, idx))
    assert gather.gather_flat_cluster_cuda.launches == before + 1
    assert gather.cluster_grid(table, cluster) >= 1


def test_alpha_only_kernel_matches_plain_on_cull_scene(dev):
    """``probe_alpha_only`` on ``make_cull_scene``, whose warp corners and
    bad conics are the cases its warp mask must get right: within 1e-5 ×
    max per channel of its plain version (the 20K-splat scene is in
    ``test_composite_probe_kernels_match_plain``)."""
    from gaussian_garments_tpu_torch.probes import composite_null

    proj = make_cull_scene(3000, 4, width=W, height=H, device=dev)
    pairs = tiles.bin_pairs(proj, image_width=W, image_height=H)
    assert bool((tiles.warp_extents(tiles.ellipse(proj))[:, 0] < 0).any())
    entry = composite_null.entries(pairs, H, W)[1]
    assert entry.name == "probe_alpha_only"
    _held(entry)


def _ladder_scene(dev, name):
    """(pairs, work list): ``bench.py``'s scene (5,039 items, odd), or the
    first seeded 20K-splat 256² scene whose work list holds an even number
    of items."""
    from gaussian_garments_tpu_torch.probes.scene import bench_scene
    from gaussian_garments_tpu_torch.probes.worklist import build_worklist

    if name == "bench":
        _, pairs = bench_scene(dev)
        wl = build_worklist(pairs.ranges)
        assert wl.n_items % 2 == 1
        return pairs, wl
    for seed in range(8):
        pairs = tiles.bin_pairs(_proj(dev, 20000, seed=seed), image_width=W, image_height=H)
        wl = build_worklist(pairs.ranges)
        if wl.n_items % 2 == 0:
            return pairs, wl
    raise AssertionError("no seeded 256² scene with an even number of work items")


@pytest.mark.parametrize("scene_name", ["bench", "seeded_256"])
def test_grid_ladder_every_variant(dev, scene_name):
    """Every ladder variant of the persistent walk at an odd and an even item
    count: the tiles the plain version zeroes are exact zeros (so free of
    NaN), the checksums agree to 1e-6 × max, every launch counts, and the
    kernel's count of output tiles written to global memory is one per tile
    that holds pairs, and 1 for d (tile 0, once)."""
    from gaussian_garments_tpu_torch.probes import grid_overhead as G

    pairs, wl = _ladder_scene(dev, scene_name)
    first_items = int((wl.k_of_item == 0).sum())
    for e in G.entries(pairs, wl):
        _held(e)
        v = e.row
        (k_out, k_sum), (p_out, p_sum) = G.grid_ladder(pairs, wl, v), G.grid_ladder_plain(pairs, wl, v)
        written = ~torch.isnan(p_out[:, 0, 0])
        assert int(written.sum()) == (1 if v == "d" else first_items)
        assert torch.equal(k_out[written], torch.zeros_like(k_out[written]))
        assert float((k_sum - p_sum).abs().max()) <= 1e-6 * float(p_sum.abs().max())
        assert G.count_tile_writes(pairs, wl, v) == (1 if v == "d" else first_items)
        assert 1 <= G.ladder_grid(wl.n_items, v, dev) <= G.n_steps(wl.n_items, v)


@pytest.mark.parametrize("n", [5, 2_097_153])
def test_gather_flat_l2_ragged(dev, n):
    """``flat_l2`` at index counts that leave a ragged int4 group: exact, and
    indices that are not 16-byte aligned are refused."""
    from gaussian_garments_tpu_torch.probes import gather

    rng = np.random.RandomState(n)
    table = torch.as_tensor(rng.randn(1184 * 128).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.randint(0, table.numel(), n + 1).astype(np.int32), device=dev)
    before = gather.gather_flat_l2_cuda.launches
    got = gather.gather_flat_l2_cuda(table, idx[:n])
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_flat_plain(table, idx[:n]))
    assert gather.gather_flat_l2_cuda.launches == before + 1
    with pytest.raises(ValueError, match="aligned"):
        gather.gather_flat_l2_cuda(table, idx[1:])


def _axis_case(dev, case):
    """(tab, idx, axis) of an axis-gather case: the TPU rows 4A and 4B; odd
    widths (tab (37, 131) / idx (19, 131) on axis 0, tab (3, 1001) / idx
    (3, 257) on axis 1); 4A's and 4B's indices as ``idx[:, 1:]`` made
    contiguous (a width of 127 or 1023; axis 0 takes ``tab[:, 1:]`` with
    them); and at a storage offset of one element, 4 bytes from 16-byte
    alignment."""
    from gaussian_garments_tpu_torch.probes import gather

    axis = int(case[-1])
    if case.startswith("odd"):
        tshape, ishape = ((37, 131), (19, 131)) if axis == 0 else ((3, 1001), (3, 257))
        rng = np.random.RandomState(axis)
        tab = torch.as_tensor(rng.randn(*tshape).astype(np.float32), device=dev)
        idx = torch.as_tensor(rng.randint(0, tshape[axis], ishape).astype(np.int32), device=dev)
        return tab, idx, axis
    tab, idx = gather.make_inputs(dev)["4A" if axis == 0 else "4B"]
    if case.startswith("row"):
        return tab, idx, axis
    if case.startswith("narrow"):
        idx = idx[:, 1:].contiguous()
        return (tab[:, 1:].contiguous() if axis == 0 else tab), idx, axis
    buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
    shifted = buf[1:].view(idx.shape)
    shifted.copy_(idx)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    return tab, shifted, axis


@pytest.mark.parametrize("case", ["row0", "row1", "odd0", "odd1", "narrow0", "narrow1",
                                  "offset0", "offset1"])
def test_gather_axis_kernels_exact(dev, case):
    """Both axis gathers equal ``gather_axis_plain`` and ``torch.gather`` bit
    for bit (row0/row1: the TPU rows 4A and 4B); the launch counts."""
    from gaussian_garments_tpu_torch.probes import gather

    tab, idx, axis = _axis_case(dev, case)
    wrapper = gather.gather_axis0_cuda if axis == 0 else gather.gather_axis1_cuda
    want = gather.gather_axis_plain(tab, idx, axis)
    assert torch.equal(want, torch.gather(tab, axis, idx.long()))
    before = wrapper.launches
    got = wrapper(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case
    assert wrapper.launches == before + 1


def test_gather_axis_waits_for_the_kernel_before_it(dev):
    """With programmatic dependent launch a gather may launch before the
    kernel ahead of it has finished. 20 rounds of three kernels back to back:
    one ``bitwise_xor`` that rewrites both the table and the indices (the
    two are views of one int32 buffer), an axis-0 gather of them, and an
    axis-1 gather whose table is that gather's output. Every output equals
    the same rounds replayed with ``torch.gather`` bit for bit."""
    from gaussian_garments_tpu_torch.probes import gather

    n, rounds = 256, 20
    rng = np.random.RandomState(3)
    init = np.concatenate([rng.randn(n * n).astype(np.float32).view(np.int32),
                           rng.randint(0, n, n * n).astype(np.int32)])
    keys = rng.randint(0, n, rounds)  # an xor below n keeps every index below n
    views = lambda blob: (blob[:n * n].view(torch.float32).view(n, n), blob[n * n:].view(n, n))
    blob = torch.as_tensor(init, device=dev)
    tab, idx = views(blob)
    before = (gather.gather_axis0_cuda.launches, gather.gather_axis1_cuda.launches)
    got = []
    for key in keys:
        torch.bitwise_xor(blob, int(key), out=blob)
        out0 = gather.gather_axis0_cuda(tab, idx)
        got.append((out0, gather.gather_axis1_cuda(out0, idx)))
    torch.cuda.synchronize()
    assert (gather.gather_axis0_cuda.launches, gather.gather_axis1_cuda.launches) == (
        before[0] + rounds, before[1] + rounds)
    ref = torch.as_tensor(init, device=dev)
    rtab, ridx = views(ref)
    for key, (out0, out1) in zip(keys, got):
        torch.bitwise_xor(ref, int(key), out=ref)
        want0 = torch.gather(rtab, 0, ridx.long())
        assert torch.equal(out0, want0)
        assert torch.equal(out1, torch.gather(want0, 1, ridx.long()))


# ---------------------------------------------------------------------------
# the s2 vertex step as one CUDA graph (``training/s2``, ``training/graph``)
# ---------------------------------------------------------------------------

def _s2_graph_case(dev, n_ring=8, width=320, height=256):
    """A 16×16 sheet with its body, its ``seq`` state, and a ring of
    ``n_ring`` cameras, each of its own focal length, with the sheet's
    ground truth."""
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.training import s2 as S2

    verts, faces, _ = syn.make_cloth_template(16, 16)
    colors = syn.face_checker_colors(faces, verts)
    ring = [syn.make_camera_ring(n_ring, fx=260.0 * (1.0 + 0.06 * i), width=width,
                                 height_px=height, device=dev)[i] for i in range(n_ring)]
    cams = syn.render_ground_truth(ring, verts, faces, colors)
    v0 = verts + np.random.RandomState(0).randn(*verts.shape).astype(np.float32) * 0.01
    params, aux, binding, _ = MG.create_from_template(v0, faces, colors, max_sh_degree=0,
                                                      device=dev)
    body_v = verts - np.array([0, 0, 0.0005], np.float32)
    mesh = MM.init_body(MM.create(v0, faces, device=dev), body_v, faces,
                        np.arange(len(verts)) % len(faces))
    return S2.init_state(params, aux, binding, mesh), cams


def _change_gap(new, ref, start):
    """The harness's ``change_median`` for the one leaf: |‖new − start‖ −
    ‖ref − start‖| / ‖ref − start‖."""
    a = float(torch.linalg.norm((new - start).double()))
    b = float(torch.linalg.norm((ref - start).double()))
    return abs(a - b) / b


def test_s2_graph_replays_the_eager_step(dev):
    """Eight ``seq`` iterations, alternating without and with the body, 4 of
    8 cameras of distinct focal lengths each: each graphed call from the
    eager trajectory's state gives the eager step's losses (1e-6 relative)
    and vertices (``change_median`` ≤ 6e-5), and the graph's own trajectory
    ends where the eager one does (≤ 6e-5); one capture per key, one replay
    per call, the compositors' launches of an eager call on every replay; a
    state a call returned is not changed by the calls after it."""
    from argparse import ArgumentParser

    from gaussian_garments_tpu_torch.config import OptimizationParams
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils import logging as log

    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    state0, ring = _s2_graph_case(dev)
    steps = {b: S2.make_s2_step(opt, mode="seq", use_body=b) for b in (False, True)}
    bg = torch.zeros(3, device=dev)
    lr = 1.6e-3
    n_cams = 4
    counts = lambda: dict(log.counters())
    delta = lambda a, b, k: b.get(k, 0) - a.get(k, 0)
    eager_s, graph_s, held = state0, state0, []
    for i in range(8):
        step = steps[i % 2 == 1]
        batch = BatchedCameras.from_cameras([ring[(3 * i + k) % len(ring)]
                                             for k in range(n_cams)])
        c0 = counts()
        new_e, loss_e, met_e = step.eager(eager_s, batch, bg, lr, lr)
        torch.cuda.synchronize()
        c1 = counts()
        new_g, loss_g, met_g = step(eager_s, batch, bg, lr, lr)
        torch.cuda.synchronize()
        c2 = counts()
        assert delta(c1, c2, "s2_graph.replay") == 1
        assert delta(c1, c2, "s2_graph.capture") == (1 if i < 2 else 0)
        for k in ("composite_fwd.launches", "composite_bwd.launches"):
            assert delta(c0, c1, k) == n_cams
            # a capture's call also runs its one eager warm-up
            assert delta(c1, c2, k) == n_cams * (2 if i < 2 else 1)
        assert list(loss_g) == list(loss_e)
        total = float(met_e["loss"])
        assert abs(float(met_g["loss"]) - total) <= 1e-6 * abs(total)
        for k in loss_e:
            assert abs(float(loss_g[k]) - float(loss_e[k])) <= 1e-6 * abs(total), k
        assert _change_gap(new_g.mesh.v, new_e.mesh.v, eager_s.mesh.v) <= 6e-5
        assert new_g.vert_adam.step == new_e.vert_adam.step == i + 1
        assert new_g.iteration == new_e.iteration == i + 1
        eager_s = new_e

        graph_s, loss, met = step(graph_s, batch, bg, lr, lr)
        held.append((graph_s, loss, met, [graph_s.mesh.v.clone(), graph_s.vert_adam.mu.clone(),
                                          graph_s.vert_adam.nu.clone(), met["loss"].clone()]))
    torch.cuda.synchronize()
    for st, loss, met, kept in held:
        now = [st.mesh.v, st.vert_adam.mu, st.vert_adam.nu, met["loss"]]
        assert all(torch.equal(a, b) for a, b in zip(now, kept))
    assert log.counters()["s2_graph.capture"] >= 2
    assert _change_gap(graph_s.mesh.v, eager_s.mesh.v, state0.mesh.v) <= 6e-5


# ---------------------------------------------------------------------------
# the s3 step as one CUDA graph (``training/s3``, ``training/graph``)
# ---------------------------------------------------------------------------

def _gaps(new, ref, start, keys):
    """The harness's gaps of ``keys``: per leaf |‖new − start‖ − ‖ref −
    start‖| / max(‖ref − start‖, the median leaf's)."""
    norm = lambda x: float(torch.linalg.norm(x.double()))
    a = {k: norm(new[k] - start[k]) for k in keys}
    b = {k: norm(ref[k] - start[k]) for k in keys}
    med = float(np.median(list(b.values())))
    return {k: abs(a[k] - b[k]) / max(b[k], med) for k in keys}


def test_s3_graph_replays_the_eager_step(dev):
    """Three ``full`` steps on items of distinct cameras: each graphed call
    from the eager trajectory's state gives the eager step's losses (1e-6 of
    their sum), and the first step's splat moments the eager ones' within
    ``grad_splats`` (0.01); the graph's own trajectory ends where the eager
    one does within ``change_median`` (0.04) for the net's leaves and for
    the splats' (the cell's limits, ``perfbench/limits/s3_train.tex512``);
    one capture, one replay a call, the compositors' launches of an eager
    call on every replay; a state a call returned is not changed by the
    calls after it."""
    from test_torch_s3_graph import _args, _leaves, s3_graph_case

    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.utils import logging as log

    net, state0, bind, faces, item = s3_graph_case(dev, n_items=1, width=256, height=192,
                                                   res=64)
    step = S3.make_s3_step(net, _args(), sh_degree=1, train_gaussians=True)
    counts = lambda: dict(log.counters())
    delta = lambda a, b, k: b.get(k, 0) - a.get(k, 0)
    start = counts()
    eager_s, graph_s, held = state0, state0, []
    for i in range(3):
        it = item(i)
        c0 = counts()
        new_e, loss_e = step.eager(eager_s, bind, faces, it)
        torch.cuda.synchronize()
        c1 = counts()
        new_g, loss_g = step(eager_s, bind, faces, it)
        torch.cuda.synchronize()
        c2 = counts()
        assert delta(c1, c2, "s3_graph.replay") == 1
        assert delta(c1, c2, "s3_graph.capture") == (1 if i == 0 else 0)
        for k in ("composite_fwd.launches", "composite_bwd.launches"):
            assert delta(c0, c1, k) == 1
            # a capture's call also runs its one eager warm-up
            assert delta(c1, c2, k) == (2 if i == 0 else 1)
        assert list(loss_g) == list(loss_e)
        total = float(sum(loss_e.values()))
        for k in loss_e:
            assert abs(float(loss_g[k]) - float(loss_e[k])) <= 1e-6 * abs(total), k
        assert new_g.net_adam.step == new_e.net_adam.step == i + 1
        assert new_g.splat_adam.step == new_e.splat_adam.step == i + 1
        assert new_g.iteration == new_e.iteration == i + 1
        if i == 0:
            g, e = _leaves(new_g), _leaves(new_e)
            zero = {k: torch.zeros_like(v) for k, v in e.items()}
            mu = [k for k in e if k.startswith("splat_mu.")]
            assert max(_gaps(g, e, zero, mu).values()) <= 0.01
        eager_s = new_e

        graph_s, loss = step(graph_s, bind, faces, it)
        leaves = _leaves(graph_s)
        held.append((leaves, loss, {k: v.clone() for k, v in leaves.items()},
                     {k: v.clone() for k, v in loss.items()}))
    torch.cuda.synchronize()
    for leaves, loss, kept_leaves, kept_loss in held:
        assert all(torch.equal(leaves[k], kept_leaves[k]) for k in leaves)
        assert all(torch.equal(loss[k], kept_loss[k]) for k in loss)
    assert delta(start, counts(), "s3_graph.capture") == 1
    assert delta(start, counts(), "s3_graph.replay") == 6
    g, e, s = _leaves(graph_s), _leaves(eager_s), _leaves(state0)
    for prefix in ("net.", "splats."):
        keys = [k for k in e if k.startswith(prefix)]
        assert float(np.median(list(_gaps(g, e, s, keys).values()))) <= 0.04, prefix


def test_s3_graph_launches_are_in_the_device_trace(dev):
    """A step captured and replayed under the profiler's device trace: the
    compositor kernels the trace shows on the card are the ones the launch
    counters report, the eager warm-up's and each replay's alike, so a
    replay's add-back of its capture's counts is what ran."""
    from test_torch_s3_graph import _args, s3_graph_case
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussian_garments_tpu_torch.training import s3 as S3

    net, state, bind, faces, item = s3_graph_case(dev, n_items=1, width=256, height=192,
                                                  res=64)
    step = S3.make_s3_step(net, _args(), sh_degree=1, train_gaussians=True)
    before = tiles.launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = step(state, bind, faces, item(i))
        torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in tiles.launches().items()}
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    traced = {k: sum(f"{k}_kernel" in n for n in names) for k in counted}
    # the first call's warm-up runs the step once eagerly; three replays
    assert counted == traced == {"composite_fwd": 4, "composite_bwd": 4}
