#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gaussian_garments_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):
1. card and versions (exits non-zero without CUDA);
2. build every kernel source of ``gaussian_garments_tpu_torch/csrc`` named in
   the registry ``ops/cuda.py``, one nvcc per source, started together;
3. ``composite_fwd`` against its plain torch version on seeded 20K-splat
   scenes at 256² (one whose wide splats hit the 6-tile clip), and against
   the exact oracle where nothing is clipped; ``composite_bwd`` against its
   plain version on the same scenes and on one saturated tile, and against
   torch autograd through the oracle at opacity ≤ 0.35; both kernels against
   their plain versions on a scene aimed at the culls (``make_cull_scene``:
   α contours past 3σ, centres on warp corners, bad conics);
4. both kernels at ``bench.py``'s shape (150K splats, 1920×1080), timed,
   beside the pairs of the plain rect
   and of the row spans and the bound: bytes, and one special-function
   evaluation per pixel-pair term that the composite sums (the same count
   for the backward), which does not depend on the binning; the walked-pair
   count (every pair a pixel walks, which does) is printed beside it;
5. the probes, through their entry points ``python -m
   gaussian_garments_tpu_torch.probes.{gather,composite_null,grid_overhead}``:
   the gather kernels at every row of the TPU scripts' table (one run per
   row), ``probe_null`` and ``probe_alpha_only`` beside ``composite_fwd`` at
   ``bench.py``'s scene, the grid-overhead ladder a–e over its work list
   (each variant's grid printed, and its writes of output tiles to global
   memory as the kernel counts them: one per tile that holds pairs, and for
   d one write of tile 0).
   Each kernel is held against its plain version (gathers exact, checksums
   1e-6 × max, ``alpha_only`` 1e-5 × max) and timed (CUDA events, mean of 20)
   beside its plain version, its library call where there is one, and its
   bound from this run's inputs (``alpha_only``: its gate-passing terms, the
   bound of every pair at every pixel printed beside it, and its share of
   ``composite_fwd``); ``gather_flat_cluster`` also at every cluster size it
   is built for (4, 8, 16), each held exact and timed with the staging and
   without it; the axis gathers (rows 4A, 4B) beside the launch floor, an
   empty kernel launched and timed the same way at their grid
   (``floor_ms``) and at one block;
6. the inference path at production width (texture 512, SH degree 3,
   940×1280, 3 frames) through ``gaussian_garments_tpu_torch.inference.main``,
   and on frame 0's bundle the forward kernel against its plain version; then
   the same with ``--exact_visibility`` (the ray cast timed per frame and at
   chunks of 256–16,384 rays, its agreement with the depth test printed per
   frame) and with ``--dense_texels`` on a garment whose UVs are inset into
   [0.1, 0.9] (its frame 0 render equal to the compact layout's bit for
   bit), the forward kernel held against its plain version on frame 0 of each;
7. the stage-2 slice at full width through
   ``gaussian_garments_tpu_torch.s2_registration.main``: a synthetic 64×64
   sheet (7,938 faces), 12 cameras at 940×1280, 2 frames, 4 cameras per step,
   a template run then a sequence run, with the artifacts, the losses, the
   densification and the kernels' launch counts checked; then the device split
   of one iteration and both kernels against their plain versions at that
   shape, timed as in phase 4;
8. the stage-3 slice at full width on phase 7's output root through
   ``gaussian_garments_tpu_torch.s3_appearance.main``: texture 512 (262,144
   texel splats), SH degree 3, the StyleUNet at full width, 940×1280, one item
   a step; the 12 cameras × 2 frames with llffhold 12 leave 22 training items
   × the 5 epochs that s3_appearance fixes = 110 steps. Cuts (printed before the run):
   ``--pre_train_iterations`` 3000 → 10 and ``--save_iterations`` 3000 → 20,
   so that both step kinds run, each epoch saves once mid-epoch and once at
   its end, and each save evaluates the 2 held-out items. The checkpoint must
   load back through the port, the losses must be finite, the img loss must
   fall, and both compositor kernels must launch; then the device split of one
   full step and both kernels against their plain versions at that shape,
   timed as in phase 4; then ``--unet_bf16`` on a copy of phase 7's output with
   the same checks and split, printed beside float32 (s/step, StyleUNet
   fwd+bwd, peak memory), and the float32 checkpoint rendered on a held-out
   item by the float32 and the bf16 net (the PSNR of all of the bf16 output
   and of its Δxyz alone printed, of its ΔSH alone ≥ 40 dB; on the JAX
   record's scene of all of it, ≥ 40 dB); then
   ``--dense_texels`` on a copy with the UVs inset, the same checks, and from
   its checkpoint in both layouts: render and per-tile pair counts equal bit
   for bit, one step's losses within 1e-4·|loss| + 1e-6, the whole step timed,
   both kernels against their plain versions at that shape;
9. stage 1 at full width through
   ``gaussian_garments_tpu_torch.s1_initialisation.main`` (``--skip_colmap``,
   the default 256³ grid and 8,000-face remesh): an ellipsoid body of
   semi-axes 0.18 × 0.12 × 0.85 m whose band 0.1 ≤ z ≤ 0.6 m is the garment,
   12 cameras at 940×1280 with masks from the port's mesh rasterizer, a
   planted ``fused.ply`` of 1,000,000 surface samples (1 mm noise) and 50,000
   green background points. At 2 mm of noise the normals' MST orientation,
   the JAX package's as the port's, flips part of the cloud inward and the
   template fails; the phase prints that share on a 2 mm cloud each run. Every artifact is checked, and the template: faces
   within 0.5–1.25× of 8,000, every vertex within 2 grid cells of the body and
   of the band in z, every band sample within 3 cells of a template vertex.
   Then ``poisson_indicator`` on the card against the CPU (χ within 1e-5 ×
   max|χ|), ``parse_scan`` on two cameras (at most 0.1% of the labels
   differ), the three ARAP terms at the s2 phase's shape (values and
   gradients at rtol 1e-5), and the split of the run (host clock, a device
   synchronize around each phase);
10. data parallelism (``phase_data_parallel``), run before phase 9: (a) 2
   gloo ranks, new processes on the one card (NCCL refuses two ranks on one
   GPU; gloo stages CUDA tensors through the host), each with TF32 off:
   stage 2's three modes at the Template state of phase 7 with a body 5 mm
   under the sheet, each rank 2 of 4 cameras, and stage 3's two step kinds
   from a fresh state at texture 512, SH 3, each rank 1 of 2 items, under
   deterministic cuDNN; each held against the one-process step on the whole
   batch (losses rtol 1e-4; s2 vertices and xyz atol 1e-6, the JAX tests';
   accumulators rtol 1e-4, counts and radii exact; the net by Adam's rule,
   99% of its entries within 1% of lr; the splats' gradients at rtol 1e-4,
   atol 1e-4 × the largest), the ranks equal bit for bit after 3 steps, the
   compositors' launches counted in each rank, and the gloo all-reduce of an
   s3 step timed; (b) both drivers under ``python -m torch.distributed.run
   --standalone --nproc_per_node 1`` with ``--data_parallel`` (NCCL) against
   the same run without it: a 6-iteration template run, and stage 3's epoch
   5 from a fresh state saved at epoch 4, 2 items a step, ``--ckpt_backend
   orbax``: the same artifacts, the first logged loss within 1e-4 and the
   rest within 1e-2, the meshes atol 1e-5, and, over the entries either run
   moved, the stage-3 parameters' median difference within 0.2 (the net) or
   0.5 (the splats) of the median movement;
11. the modules no driver runs (``phase_unused_modules``): the wavelet
   ``Discriminator(512, img_channel=6)`` forward (batch 4) and ``lbs`` at
   SMPL-X's shapes on the card against the CPU, timed;
12. the production drive (``phase_prod_drive``), run after phase 9: ``python -m
   gaussian_garments_tpu_torch.prod_drive`` at full width (12 cameras at 1024²,
   nx 48, texture 512, SH 3, inference at 940×1280) and a cut depth
   (``PD_CUTS``), every leg a child process: dataset, s2 template, s2
   sequence, s3 killed at its first committed checkpoint and resumed to "Epoch
   5", eval-only in float32 and with ``--unet_bf16``, inference. The phase
   checks every leg's artifacts, the kill and the resume, finite quality in
   every leg with the bf16 eval within ``PD_BF16_DB`` dB of float32's, the
   forward kernel's launches in the dataset, s2, s3, eval and inference legs
   and the backward's in the s2 and s3 legs, and no JAX module in any child;
   then it holds both compositor kernels against their plain versions at the
   drive's own s2 and s3 shapes (1024², over 99% of the tiles empty), and
   their errors join the kernel summary's ``max_abs_err``;
13. the kernel summary line (``floor_ms``: the launch floor where the probe
   times one, else null), the card line and the result line.

Iteration counts of phases 7 and 8 are cuts of the production schedule.
Imports nothing of JAX. Every number it prints is measured in this run,
except ``bound_ms``, which it computes from this run's inputs. Launch counts
are zeroed just before each path is driven and read just after; the
compositor kernels' ``launches`` in the summary are those of the stage-3 run,
counted from its device trace (its steps replay a CUDA graph, whose kernels
no host code launches; the trace's count must equal the counters'), and
every other path must launch them too, the data-parallel ranks included. The time the phases of the bf16,
dense and exact-visibility paths took is printed before the summary.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, TEXTURE, SH_DEGREE, FRAMES = 940, 1280, 512, 3, 3
S2_CAMS, S2_NX, S2_FRAMES, S2_PER_STEP = 12, 64, 2, 4
S2_TEMPLATE = ["-tf", "0", "--first_frame_iterations", "150", "--ff_collision_iteration", "50",
               "--densify_from_iter", "50", "--densification_interval", "50",
               "--opacity_reset_interval", "100", "--densify_grad_threshold", "4e-8"]
S2_SEQUENCE = ["-t", "Template", "--first_frame_iterations_cross", "40",
               "--other_frame_iterations", "40", "--collision_iteration", "10",
               "--ff_collision_iteration", "10"]
S2_CUTS = ("first_frame_iterations 10000 -> 150, ff_collision_iteration 2000 -> 50, "
           "first_frame_iterations_cross 15000 -> 40, other_frame_iterations 5000 -> 40, "
           "collision_iteration 2000 -> 10, densify_from_iter 500 -> 50, "
           "densification_interval 100 -> 50, opacity_reset_interval 3000 -> 100; "
           "densify_grad_threshold 2e-4 -> 4e-8: the statistics are pixel-space gradients "
           "of a loss averaged over 4 x 940 x 1280 pixels, ~3e-8 on this scene")
S3_ARGS = ["-s", "subj", "--texture_size", str(TEXTURE), "--sh_degree", str(SH_DEGREE),
           "--items_per_step", "1", "--pre_train_iterations", "10", "--save_iterations", "20",
           "--device", "cuda"]
S3_CUTS = ("pre_train_iterations 3000 -> 10, save_iterations 3000 -> 20; s3_appearance's "
           "fixed 5 epochs stay: 22 training items x 5 epochs = 110 steps, 10 pre-training (net "
           "only), 100 full; 10 saves, each with an eval of the 2 held-out items")
S3_STEPS, S3_PRE = 110, 10
UV_INSET = 0.1   # the inset scenes of the dense-layout phases: ~36% dead texels
PROBE_REPS = 20
S1_AXES, S1_BAND = (0.18, 0.12, 0.85), (0.1, 0.6)   # body semi-axes, garment band in z (m)
S1_CAMS, S1_POINTS, S1_GREEN, S1_NOISE = 12, 1_000_000, 50_000, 0.001
S1_DEFECT_NOISE = 0.002         # the noise at which the normals' orientation fails
S1_RES, S1_FACES = 256, 8000    # the JAX default grid 2^min(13, 8) and --remesh_faces
S1_MESH = (68, 96)              # rings per half of z, segments around: the body mesh
PD_ARGS = ["--frames", "2", "--tmpl_iters", "150", "--tmpl_coll", "50", "--frame_iters", "40",
           "--frame_coll", "10", "--save_iterations", "10", "--device", "cuda"]
PD_CUTS = ("frames 8 -> 2 (2 inference frames); template iterations 3000 + 600 -> 150 + 50; "
           "sequence 2400 on frame 0 and 1200 on each other -> 80 and 40, collision 240 -> 10; "
           "save_iterations 40 -> 10, so that the kill lands at item 10 of epoch 1's 22")
PD_BF16_DB = 0.1        # the eval-only bf16 PSNR within this of float32's
PD_TIMEOUT = 900
S1_CUTS = ("12 cameras (captures such as ActorsHQ's have 160); COLMAP is not run "
           "(--skip_colmap, no COLMAP on the card's machine): fused.ply is planted; its noise "
           "1 mm, since at 2 mm the normals' orientation fails (printed below)")


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to deterministic algorithms: its default algorithm
    for the StyleUNet's transposed convolution sums in a run-dependent order
    (the net's output moves by ~1e-5 from one call to the next), which would
    hide whether two texel layouts render the same."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(a, b):
    return float((a - b).abs().max())


def compare_fwd(torch, k, p, depth_range, what):
    """Forward kernel vs plain: image/alpha 1e-4, depth 1e-3 × the depth range."""
    e_img = max(max_err(k.color, p.color), max_err(k.alpha, p.alpha))
    e_depth = max_err(k.depth, p.depth)
    print(f"{what}: fwd max |kernel - plain| color/alpha {e_img:.3g}, depth {e_depth:.3g} "
          f"(depth range {depth_range:.3g})")
    check(e_img <= 1e-4, f"{what}: color/alpha differ by {e_img}")
    check(e_depth <= 1e-3 * depth_range, f"{what}: depth differs by {e_depth}")
    check(bool(torch.isfinite(k.color).all()), f"{what}: non-finite kernel output")
    return max(e_img, e_depth)


def compare_bwd(torch, tiles, pairs, out, cot, h, w, tol, what):
    """Backward kernel vs plain, per gradient component: max |kernel − plain|
    ≤ tol × max |plain| (the atomics sum in a run-dependent order)."""
    kw = dict(image_height=h, image_width=w)
    k = tiles.composite_tiles_backward_cuda(pairs, out.final_logt, out.last_pair, *cot, **kw)
    p = tiles.composite_tiles_backward_plain(pairs, out.final_logt, out.last_pair, *cot, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), f"{what}: non-finite backward kernel output")
    check(bool((k[:, 10:] == 0).all()), f"{what}: columns 10-11 must stay zero")
    err = (k - p)[:, :10].abs().amax(dim=0)
    scale = p[:, :10].abs().amax(dim=0)
    rel = float((err / scale.clamp(min=1e-30)).max())
    print(f"{what}: bwd max |kernel - plain| {float(err.max()):.3g}, "
          f"worst component {rel:.3g} x max|plain| (tolerance {tol:g})")
    check(rel <= tol, f"{what}: backward differs by {rel} x max|plain|")
    return float(err.max())


def cotangents(torch, dev, h, w, seed):
    import numpy as np
    g = torch.as_tensor(np.random.RandomState(seed).randn(5, h, w).astype(np.float32),
                        device=dev)
    return g[:3].contiguous(), g[3:4].contiguous(), g[4:5].contiguous()


def hold_kernels(torch, dev, proj, h, w, seed, what):
    """Bin ``proj`` and hold both compositor kernels against their plain
    versions at that shape (seeded cotangents for the backward); prints the
    pair count and the share of tiles the frame leaves empty. Returns
    (errors, pairs, forward output, cotangents)."""
    from gaussian_garments_tpu_torch.ops import tiles

    pairs = tiles.bin_pairs(proj, image_width=w, image_height=h)
    k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
    p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
    per_tile = pairs.ranges[1:] - pairs.ranges[:-1]
    print(f"{what}: {int(pairs.ranges[-1])} pairs, {float((per_tile == 0).float().mean()):.4f} "
          f"of {per_tile.numel()} tiles empty")
    live = proj.radii > 0
    errs = {"composite_fwd": compare_fwd(
        torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()), what)}
    cot = cotangents(torch, dev, h, w, seed)
    errs["composite_bwd"] = compare_bwd(torch, tiles, pairs, k, cot, h, w, 1e-4, what)
    return errs, pairs, k, cot


@contextlib.contextmanager
def data_roots(data_root, output_root):
    """The port's path registry pointed at another run's data and output
    roots for a while."""
    from gaussian_garments_tpu_torch.config import DEFAULTS

    old = DEFAULTS.data_root, DEFAULTS.output_root
    DEFAULTS.data_root, DEFAULTS.output_root = data_root, output_root
    try:
        yield
    finally:
        DEFAULTS.data_root, DEFAULTS.output_root = old


def s2_template_state(torch, dev, out_root, sequence):
    """The trained Template state under ``out_root`` and frame 0's cameras
    of ``sequence``: (options, state, cameras)."""
    import pickle
    from pathlib import Path

    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import FrameDataloader
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.s2_registration import parse_args
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils.io import read_obj

    args, _, op = parse_args(["-s", "subj", "-q", sequence])
    root = Path(out_root) / "subj"
    args.subject_out = root
    cams = FrameDataloader(args, device=dev).load_frame(0)
    tmpl = root / DEFAULTS.stage2 / "Template"
    params, aux = G.load_ply(str(tmpl / "local_point_cloud.ply"), 0, device=dev)
    with open(tmpl / "binding.pkl", "rb") as f:
        binding = pickle.load(f)
    tem = read_obj(root / DEFAULTS.stage1 / "template_uv.obj")
    mesh = MM.create(read_obj(tmpl / "template.obj")["vertices"], tem["faces"], device=dev)
    return op.extract(args), S2.init_state(params, aux, binding, mesh), cams


def s2_project(torch, state, batch, b):
    """Camera ``b`` of ``batch``'s projection of the stage-2 state's splats."""
    from gaussian_garments_tpu_torch.renderer import _project
    from gaussian_garments_tpu_torch.training import s2 as S2

    with torch.no_grad():
        bundle = S2.splat_bundle(state.params, state.binding, state.aux.alive, state.mesh.v,
                                 state.mesh.f)
        return _project(bundle, batch.world_view[b], batch.full_proj[b], batch.campos[b],
                        width=batch.width, height=batch.height, tanfovx=batch.tanfovx[b],
                        tanfovy=batch.tanfovy[b], scaling_modifier=1.0, vis_mask=None,
                        screen_offset=None)


def s3_project(torch, run, item, sh_degree):
    """The first camera of ``item``'s projection of the stage-3 run's texel
    splats, through its net."""
    from gaussian_garments_tpu_torch.renderer import _project
    from gaussian_garments_tpu_torch.training import s3 as S3

    net, state = run.net, run.state
    with torch.no_grad():
        bundle, vis, _ = S3._s3_project(
            net, S3._cast_net_vars(net, (state.net_params, state.net_buffers)),
            state.splats, run.bind, run.mesh_f, item, 0, sh_degree=sh_degree)
        return _project(bundle, item.world_view[0], item.full_proj[0], item.campos[0],
                        width=item.width, height=item.height, tanfovx=item.tanfovx[0],
                        tanfovy=item.tanfovy[0], scaling_modifier=1.0, vis_mask=vis,
                        screen_offset=None), vis


def summed_terms(torch, pairs, out):
    """The pixel-pair terms that the composite sums, which the backward walks
    back: at each pixel, the pairs up to its last contributing one that pass
    the gates (power <= 0, alpha >= 1/255). They do not depend on the
    binning. A loop over the per-tile slot k, tiles in order of decreasing
    walk, vectorised over (tiles x 512 pixels)."""
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.rasterizer_ref import ALPHA_EPS, ALPHA_MAX

    tx, ty = pairs.tiles_x, pairs.tiles_y
    last = tiles._tile_pixels(out.last_pair.long(), tx, ty, -1)
    starts = pairs.ranges[:-1].long()
    walk = torch.clamp(last.max(dim=1).values - starts + 1, min=0)
    order = torch.argsort(walk, descending=True, stable=True)
    walk_host = walk[order].tolist()
    starts, last = starts[order], last[order]
    p = torch.arange(tiles.PIX, device=last.device)
    px = ((order % tx)[:, None] * tiles.TILE_W + (p % tiles.TILE_W)[None, :]).float()
    py = ((order // tx)[:, None] * tiles.TILE_H + (p // tiles.TILE_W)[None, :]).float()
    total, m = torch.zeros((), dtype=torch.int64, device=last.device), len(walk_host)
    for k in range(walk_host[0] if walk_host else 0):
        while walk_host[m - 1] <= k:
            m -= 1
        pid = starts[:m] + k
        f = pairs.feats[pairs.pair_splat[pid].long()]
        col = lambda i: f[:, i:i + 1]
        dx, dy = col(0) - px[:m], col(1) - py[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        al = torch.clamp(col(5) * torch.exp(power), max=ALPHA_MAX)
        total += ((pid[:, None] <= last[:m]) & (power <= 0.0) & (al >= ALPHA_EPS)).sum()
    return int(total)


def work(torch, proj, pairs, out, h, w):
    """Bytes each kernel must move and the special-function evaluations this
    run's data needs: one per pixel-pair term that the composite sums
    (``summed_terms``), the same set for the backward. Also the walked-pair
    counts, which depend on the binning (forward: every pair of the tile at every
    pixel until it saturates or the range ends; backward: every pair from a
    pixel's last contributing one back to its tile's start), the pairs of
    the plain rect and of the row spans, and what the warp cull leaves
    (``probes.composite_null.warp_lanes``)."""
    import math

    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.rasterizer_ref import T_EPS
    from gaussian_garments_tpu_torch.probes.common import HBM_BYTES_S, SFU_OPS_S
    from gaussian_garments_tpu_torch.probes.composite_null import warp_lanes
    starts = pairs.ranges[:-1].long()
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).long()
    tiled = lambda x, fill: tiles._tile_pixels(x, pairs.tiles_x, pairs.tiles_y, fill)
    last = tiled(out.last_pair.long(), -1)
    logt = tiled(out.final_logt, 0.0)
    inside = tiled(torch.ones_like(out.final_logt), 0.0) > 0
    walk = torch.where(last >= 0, last - starts[:, None] + 1, torch.zeros_like(last))
    saturated = logt < math.log(T_EPS)
    fwd_walk = torch.where(saturated, walk, counts[:, None].expand_as(walk))
    x0, y0, x1, y1, alive = tiles.tile_rects(proj, tiles_x=pairs.tiles_x, tiles_y=pairs.tiles_y)
    side = 6
    rect = torch.where(alive, (x1 - x0).clamp(0, side) * (y1 - y0).clamp(0, side), 0)
    terms = summed_terms(torch, pairs, out)
    n, p, t = pairs.feats.shape[0], int(pairs.ranges[-1]), pairs.ranges.numel()
    hw = h * w
    fwd_bytes = n * 48 + p * 4 + t * 4 + hw * 4 * 7
    bwd_bytes = n * 48 + p * 4 + t * 4 + hw * 4 * 7 + n * 48
    bound = lambda b, e: max(b / HBM_BYTES_S, e / SFU_OPS_S) * 1e3
    by = lambda b, e: "bytes" if b / HBM_BYTES_S >= e / SFU_OPS_S else "operations"
    walked = {"composite_fwd": (fwd_bytes, int(torch.where(inside, fwd_walk, 0).sum())),
              "composite_bwd": (bwd_bytes, int(walk.sum()))}
    return {"composite_fwd": (bound(fwd_bytes, terms), by(fwd_bytes, terms), fwd_bytes, terms),
            "composite_bwd": (bound(bwd_bytes, terms), by(bwd_bytes, terms), bwd_bytes, terms),
            "walked_evals": {k: e for k, (_, e) in walked.items()},
            "walked_bound_ms": {k: bound(b, e) for k, (b, e) in walked.items()},
            "rect_pairs": int(rect.sum()), "pairs": p, "warp_evals": warp_lanes(pairs)}


def time_both(torch, tiles, proj, pairs, out, cot, h, w, what):
    """Both kernels and their plain versions, timed, beside their bounds and
    the pair counts."""
    from gaussian_garments_tpu_torch.probes.common import cuda_ms

    kw = dict(image_height=h, image_width=w)
    args = (pairs, out.final_logt, out.last_pair, *cot)
    res = {
        "composite_fwd": (cuda_ms(lambda: tiles.composite_tiles_cuda(pairs, **kw), 20),
                          cuda_ms(lambda: tiles.composite_tiles_plain(pairs, **kw), 1)),
        "composite_bwd": (
            cuda_ms(lambda: tiles.composite_tiles_backward_cuda(*args, **kw), 20),
            cuda_ms(lambda: tiles.composite_tiles_backward_plain(*args, **kw), 1)),
    }
    wk = work(torch, proj, pairs, out, h, w)
    counts = pairs.ranges[1:] - pairs.ranges[:-1]
    print(f"{what}: {pairs.feats.shape[0]} splats; pairs: {wk['rect_pairs']} in the plain rect, "
          f"{wk['pairs']} after the row-span cull ({wk['pairs'] / max(wk['rect_pairs'], 1):.4f}); "
          f"deepest tile {int(counts.max())} pairs, {counts.numel()} tiles; "
          f"{wk['composite_fwd'][3]} pixel-pair terms summed, {wk['warp_evals']} lane "
          f"evaluations left by the warp cull before early stops ({512 * wk['pairs']} without it)")
    for name, (ms, plain) in res.items():
        b, by, nbytes, terms = wk[name]
        print(f"  {name}: kernel {ms:.4f} ms (CUDA events, mean of 20), plain {plain:.2f} ms "
              f"(mean of 1), bound {b:.4f} ms by {by} ({nbytes} B, {terms} terms); walked-pair "
              f"count {wk['walked_evals'][name]} pixel-pair evaluations, bound "
              f"{wk['walked_bound_ms'][name]:.4f} ms")
    return {name: (ms, plain, wk[name][0], wk[name][1]) for name, (ms, plain) in res.items()}


def ellipsoid_mesh(axes, rings, segments):
    """A closed ellipsoid mesh with its vertex rings at z = k·c/rings (k from
    −rings to rings), so that the band's edges at 0.1 and 0.6 m lie on rings."""
    import numpy as np

    a, b, c = axes
    zs = np.linspace(-c, c, 2 * rings + 1)[1:-1]
    r = np.sqrt(np.maximum(1.0 - (zs / c) ** 2, 0.0))
    ph = 2 * np.pi * np.arange(segments) / segments
    ring_v = np.stack([a * r[:, None] * np.cos(ph), b * r[:, None] * np.sin(ph),
                       np.repeat(zs[:, None], segments, 1)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, -c]], ring_v, [[0, 0, c]]]).astype(np.float32)
    n_r, top = len(zs), len(verts) - 1
    at = lambda i, j: 1 + i * segments + j % segments
    faces = [(0, at(0, j + 1), at(0, j)) for j in range(segments)]
    faces += [(top, at(n_r - 1, j), at(n_r - 1, j + 1)) for j in range(segments)]
    for i in range(n_r - 1):
        for j in range(segments):
            faces += [(at(i, j), at(i, j + 1), at(i + 1, j)),
                      (at(i, j + 1), at(i + 1, j + 1), at(i + 1, j))]
    return verts, np.asarray(faces, np.int64)


def ellipsoid_samples(axes, n, rng):
    """n area-uniform samples on the ellipsoid (rejection on the sphere's
    map by the area element) and their outward unit normals."""
    import numpy as np

    a, b, c = axes
    out, nrm = [], []
    g_max = max(b * c, a * c, a * b)
    while sum(len(o) for o in out) < n:
        u = rng.randn(2 * n, 3)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        g = np.sqrt((b * c * u[:, 0]) ** 2 + (a * c * u[:, 1]) ** 2 + (a * b * u[:, 2]) ** 2)
        u = u[rng.rand(2 * n) < g / g_max]
        out.append(u * np.array([a, b, c]))
        m = u / np.array([a, b, c])
        nrm.append(m / np.linalg.norm(m, axis=1, keepdims=True))
    return np.concatenate(out)[:n], np.concatenate(nrm)[:n]


def write_s1_capture(torch, dev, data_root, out_root, subject, rng):
    """The stage-1 scene in the reference layout: ``S1_CAMS`` cameras at
    WIDTH×HEIGHT around the body, RGB, foreground and garment masks from the
    port's mesh rasterizer, and the planted fused cloud. Returns the
    noise-free surface samples."""
    import numpy as np
    from gaussian_garments_tpu_torch.data.synthetic import fit_focal, make_camera_ring
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
    from gaussian_garments_tpu_torch.utils.io import save_image, store_ply

    verts, faces = ellipsoid_mesh(S1_AXES, *S1_MESH)
    z = verts[faces].mean(1)[:, 2]
    garment = torch.as_tensor((z > S1_BAND[0]) & (z < S1_BAND[1]), device=dev)
    ring = dict(n=S1_CAMS, radius=2.5, height=0.4)
    fx = fit_focal(verts, width=WIDTH, height_px=HEIGHT, cover=0.9, **ring)
    cams = make_camera_ring(fx=fx, width=WIDTH, height_px=HEIGHT, device=dev, **ring)
    seq = os.path.join(data_root, subject, "seq")
    v_t, f_t = torch.as_tensor(verts, device=dev), torch.as_tensor(faces, device=dev)
    cam_json, cover = {}, []
    for k, cam in enumerate(cams):
        name = f"Cam{k:03d}"
        intr = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
        extr = np.concatenate([cam.R.T, np.asarray(cam.T)[:, None]], axis=1)
        cam_json[name] = {"intrinsics": intr.tolist(), "extrinsics": extr.tolist(), "ids": k}
        with torch.no_grad():
            p2f, _ = rasterize_mesh(v_t, f_t, cam.world_view_transform, cam.full_proj_transform,
                                    image_width=WIDTH, image_height=HEIGHT)
        fg = p2f >= 0
        gm = fg & garment[p2f.clamp(min=0)]
        shade = 0.3 + 0.4 * (p2f.clamp(min=0) % 7).to(torch.float32) / 6
        fg, gm, shade = (x.cpu().numpy() for x in (fg, gm, shade))
        cover.append(float(gm.mean()))
        save_image(os.path.join(seq, name, "rgb_images", "00000.png"),
                   np.stack([shade * fg] * 3, -1))
        save_image(os.path.join(seq, name, "garment_masks", "00000.png"), gm.astype(np.float32))
        save_image(os.path.join(seq, name, "foreground_masks", "00000.png"),
                   fg.astype(np.float32))
    with open(os.path.join(seq, "cameras.json"), "w") as f:
        json.dump(cam_json, f)

    surface, normals = ellipsoid_samples(S1_AXES, S1_POINTS, rng)
    noisy = surface + normals * rng.randn(S1_POINTS, 1) * S1_NOISE
    green = rng.rand(S1_GREEN, 3) * np.array([3.0, 3.0, 2.0]) - np.array([1.5, 1.5, 1.0])
    colors = np.concatenate([np.full((S1_POINTS, 3), 128.0),
                             np.tile([[20.0, 230.0, 20.0]], (S1_GREEN, 1))])
    stage1 = os.path.join(out_root, subject, "stage1")
    os.makedirs(stage1)
    store_ply(os.path.join(stage1, "fused.ply"), np.concatenate([noisy, green]), colors)
    print(f"s1 data: {S1_CAMS} cameras at {WIDTH}x{HEIGHT} (focal {fx:.1f} px), the body an "
          f"ellipsoid of semi-axes {S1_AXES} m ({len(faces)} faces), the garment the band "
          f"{S1_BAND[0]} <= z <= {S1_BAND[1]} m covering {min(cover):.3f}-{max(cover):.3f} of "
          f"each frame; fused.ply: {S1_POINTS} surface samples with {S1_NOISE * 1e3:g} mm "
          f"noise, grey, and {S1_GREEN} green background points")
    return surface


def phase_s1(torch, dev, data_root, out_root, card):
    """Stage 1 at full width through ``s1_initialisation.main``, its
    artifacts and template checked; the Poisson solve and ``parse_scan`` on
    the card against the CPU; the ARAP terms at the s2 phase's shape on the
    card against the CPU; the split."""
    import numpy as np
    from gaussian_garments_tpu_torch import s1_initialisation
    from gaussian_garments_tpu_torch.stages import meshing, s1
    from gaussian_garments_tpu_torch.utils.io import fetch_ply, read_obj
    from scipy.spatial import cKDTree

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    surface = write_s1_capture(torch, dev, data_root, out_root, "body", np.random.RandomState(5))
    print(f"s1 cuts: {S1_CUTS}")
    # --grid_res unset: the driver's default grid, 2^min(13, 8) = S1_RES
    result = s1_initialisation.main(["-s", "body", "-q", "seq", "--skip_colmap",
                                     "--remesh_faces", str(S1_FACES),
                                     "--device", "cuda" if dev.type == "cuda" else "cpu"])
    stage1 = result["target_root"]
    missing = [a for a in s1_initialisation.ARTIFACTS if a not in result["artifacts"]]
    check(not missing, f"missing s1 artifacts: {missing}")
    check(len(os.listdir(stage1 / "masks")) == S1_CAMS, "one exported mask per camera")

    cloud = fetch_ply(stage1 / "point_cloud.ply").points.astype(np.float32)
    cell = (cloud.max(0) - cloud.min(0)).max() / 0.8 / (S1_RES - 1)
    scan, parser, tmpl = (read_obj(stage1 / n) for n in ("poisson.obj", "parser.obj",
                                                          "template.obj"))
    tv, tf = tmpl["vertices"], tmpl["faces"]
    d_body, _ = cKDTree(surface).query(tv)
    band = surface[(surface[:, 2] >= S1_BAND[0]) & (surface[:, 2] <= S1_BAND[1])]
    # distance to the template's surface, sampled at 15 barycentric points per face
    w = np.array([(i, j, 4 - i - j) for i in range(5) for j in range(5 - i)], np.float64) / 4
    d_band, _ = cKDTree(np.einsum("sk,fkc->fsc", w, tv[tf]).reshape(-1, 3)).query(band)
    lo, hi = S1_BAND[0] - 2 * cell, S1_BAND[1] + 2 * cell
    print(f"s1 meshes: filtered cloud {len(cloud)} points, grid {S1_RES}^3 (cell "
          f"{cell * 1e3:.3f} mm); scan {len(scan['vertices'])} vertices / "
          f"{len(scan['faces'])} faces; garment cut {len(parser['vertices'])} vertices; "
          f"template {len(tv)} vertices / {len(tf)} faces")
    print(f"s1 template: faces {len(tf)} (limits {S1_FACES // 2}-{S1_FACES * 5 // 4}); "
          f"largest vertex distance to the body {d_body.max() * 1e3:.3f} mm (limit "
          f"{2 * cell * 1e3:.3f}); vertex z {tv[:, 2].min():.4f}-{tv[:, 2].max():.4f} m "
          f"(limits {lo:.4f}-{hi:.4f}); largest distance from a band sample to the template "
          f"{d_band.max() * 1e3:.3f} mm over {len(band)} samples (limit {3 * cell * 1e3:.3f})")
    check(S1_FACES // 2 <= len(tf) <= S1_FACES * 5 // 4, f"template has {len(tf)} faces")
    check(d_body.max() <= 2 * cell, "a template vertex lies off the body")
    check(tv[:, 2].min() >= lo and tv[:, 2].max() <= hi, "a template vertex lies off the band")
    check(d_band.max() <= 3 * cell, "the template leaves part of the band uncovered")

    # the card against the CPU on the same inputs
    normals = meshing.estimate_normals(cloud)
    chi = {d.type: meshing.poisson_indicator(cloud, normals, res=S1_RES, device=d)[0]
           for d in (dev, cpu)}
    e_chi = float(np.abs(chi[dev.type] - chi["cpu"]).max()) / float(np.abs(chi["cpu"]).max())
    print(f"s1 poisson_indicator at {S1_RES}^3, card against CPU: max |d chi| = "
          f"{e_chi:.3g} x max |chi| (limit 1e-5)")
    check(e_chi <= 1e-5, "chi differs between the card and the CPU")
    labels = {}
    for d in (dev, cpu):
        cams, masks = s1.load_segmentation_inputs(stage1, device=d)
        labels[d.type] = s1.parse_scan(scan["vertices"], scan["faces"], cams[:2], masks[:2],
                                       device=d) > 0.5
    n_diff = int((labels[dev.type] != labels["cpu"]).sum())
    print(f"s1 parse_scan on 2 cameras, card against CPU: {n_diff} of {len(labels['cpu'])} "
          f"labels differ (limit 0.1%), {int(labels['cpu'].sum())} in the garment")
    check(n_diff <= 1e-3 * len(labels["cpu"]), "parse_scan labels differ")
    arap_err = check_arap(torch, dev)
    report_orientation_defect(np.random.RandomState(5))

    split = result["split"]
    order = ("export", "load_masks", "read_cloud", "filter", "normals", "splat", "fft_solve",
             "iso", "surface_nets", "largest_component", "parse_scan", "remesh", "fps")
    parts = []
    for k in order:
        t = split[k]
        parts.append(f"{k} {sum(t):.3f}" + (f" ({len(t)} x, {min(t):.3f}-{max(t):.3f} each)"
                                            if len(t) > 1 else ""))
    print("s1 split, s (host clock, a device synchronize around each phase; fps is inside "
          "remesh): " + ", ".join(parts) + f"; whole stage {result['seconds']:.3f}")
    secs = time.perf_counter() - t_phase
    print(f"s1 phase: {secs:.1f} s ({card})")
    return secs, arap_err


def report_orientation_defect(rng):
    """The share of the normals that ``estimate_normals`` orients inward on
    the phase's cloud with ``S1_DEFECT_NOISE`` of noise, filtered as
    ``post_process`` filters it. Printed, not gated: the MST over Euclidean
    weights, which the port copies from the JAX package, crosses between the
    layers of a noisy shell, and each wrong edge flips a subtree."""
    import numpy as np
    from gaussian_garments_tpu_torch.stages import meshing, s1
    from scipy.spatial import cKDTree

    surface, normals = ellipsoid_samples(S1_AXES, S1_POINTS, rng)
    noisy = surface + normals * rng.randn(S1_POINTS, 1) * S1_DEFECT_NOISE
    pts, _ = s1.filter_green_and_outliers(noisy, np.full((S1_POINTS, 3), 0.5))
    est = meshing.estimate_normals(pts.astype(np.float32))
    inward = float(np.mean(np.einsum("ij,ij->i", est, normals[cKDTree(surface).query(pts)[1]])
                           < 0))
    print(f"s1 normals at {S1_DEFECT_NOISE * 1e3:g} mm of noise ({len(pts)} filtered points): "
          f"{inward:.4f} of them point inward (a defect shared with the JAX package: the "
          "template fails there)")


def check_arap(torch, dev):
    """The three ARAP terms at the s2 phase's shape (a 64×64 sheet, 7,938
    faces, one splat per face, 20 neighbours; the sheet 0.1 m wide, so that
    the exp(−2000·distance) weights of both graphs are not vanishingly small):
    ``Scene.arap_cache`` on the card and on the CPU from one
    ``post_each_frame``, values and gradients (xyz, rotation, vertices) at
    rtol 1e-5, atol 1e-7."""
    from types import SimpleNamespace

    import numpy as np
    from gaussian_garments_tpu_torch.data.synthetic import make_cloth_template
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.scene import Scene

    rng = np.random.RandomState(8)
    vt, f, _ = make_cloth_template(S2_NX, S2_NX, size=0.1)
    binding = np.arange(len(f))
    xyz0 = (vt[f].mean(1) + rng.randn(len(f), 3) * 0.0002).astype(np.float32)
    rot0 = rng.randn(len(f), 4).astype(np.float32)
    xyz = (xyz0 + rng.randn(*xyz0.shape) * 0.0003).astype(np.float32)
    rot = (rot0 + rng.randn(*rot0.shape) * 0.1).astype(np.float32)
    mesh_v = (vt + rng.randn(*vt.shape) * 0.0003).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = Scene(SimpleNamespace(subject_out="", sequence=""), SimpleNamespace(device=d))
        scene.post_each_frame(True, xyz0, rot0, vt, f, binding)
        cache = scene.arap_cache()
        t = lambda a: torch.as_tensor(a, device=d)
        args = [t(a).requires_grad_(True) for a in (xyz, rot, mesh_v)]
        dyn = MG.dynamic_3d_loss(cache, args[0], args[1], 0.7)
        terms = {"gg": MG.gg_arap_loss(cache, args[0], args[1]),
                 "gv": MG.gv_arap_loss(cache, args[0], args[1], args[2], t(f), t(binding)),
                 "rigid": dyn["rigid"], "rot": dyn["rot"]}
        out[d.type] = {k: [v.detach()] + [g if g is None else g.detach() for g in
                                          torch.autograd.grad(v, args, allow_unused=True,
                                                              retain_graph=True)]
                       for k, v in terms.items()}
    worst = 0.0
    for k, vals in out[dev.type].items():
        for i, (a, b) in enumerate(zip(vals, out["cpu"][k])):
            if b is None:
                check(a is None, f"ARAP {k}: gradient {i} only on the card")
                continue
            a = a.cpu()
            err = float(((a - b).abs() - 1e-5 * b.abs()).max())
            worst = max(worst, float((a - b).abs().max()))
            check(err <= 1e-7, f"ARAP {k}: output {i} differs by {err} beyond rtol 1e-5")
    print("s1 ARAP terms at " + f"{len(f)} splats x 20 neighbours, card against CPU: "
          + ", ".join(f"{k} {float(v[0]):.6g}" for k, v in out["cpu"].items())
          + f"; values and gradients within rtol 1e-5, atol 1e-7 (max |diff| {worst:.3g})")
    return worst


def phase_kernel_checks(torch, dev):
    import numpy as np
    from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene, make_splat_scene
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
    from gaussian_garments_tpu_torch.probes.scene import project_arrays
    from gaussian_garments_tpu_torch.utils.camera import make_camera

    size = 256
    cam = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=300, fy=300, cx=size / 2,
                      cy=size / 2, width=size, height=size, device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    errs = {"composite_fwd": 0.0, "composite_bwd": 0.0}
    # (wide splats, max opacity, held against the oracle too): the oracle keeps
    # the α tails outside a splat's 3σ rect that the tiled path drops, so the
    # oracle scene keeps opacities ≤ 0.35, where those tails are below 1/255
    for seed, (n_wide, max_opacity, oracle) in enumerate(
            ((0, 0.35, True), (0, 1.0, False), (8, 1.0, False))):
        proj = project_arrays(cam, make_splat_scene(
            20000, 0, n_wide=n_wide, max_opacity=max_opacity), size, size)
        pairs = tiles.bin_pairs(proj, image_width=size, image_height=size)
        k = tiles.composite_tiles(pairs, image_height=size, image_width=size)
        p = tiles.composite_tiles_plain(pairs, image_height=size, image_width=size)
        torch.cuda.synchronize()
        drange = float(proj.depth.max() - proj.depth.min())
        n_clipped = int(pairs.n_clipped)
        what = (f"scene 20000 splats + {n_wide} wide, opacity <= {max_opacity} @ {size}², "
                f"{int(pairs.ranges[-1])} pairs, n_clipped {n_clipped}")
        errs["composite_fwd"] = max(errs["composite_fwd"], compare_fwd(torch, k, p, drange, what))
        check((n_clipped > 0) == (n_wide > 0), f"{what}: unexpected clip count")
        errs["composite_bwd"] = max(errs["composite_bwd"], compare_bwd(
            torch, tiles, pairs, k, cotangents(torch, dev, size, size, seed), size, size,
            1e-4, what))
        if not oracle:
            continue
        # The oracle accumulates log T by cumsum, so the T >= 1e-4 gate can flip
        # on a pixel and move its alpha by at most 1e-4: tolerance 2e-4.
        ir, dr, ar = rasterize_reference(proj, image_height=size, image_width=size, bg=bg,
                                         pixel_chunk=4096)
        img = k.color + (1.0 - k.alpha) * bg[:, None, None]
        e = max(max_err(img, ir), max_err(k.alpha, ar))
        e_d = max_err(k.depth, dr)
        print(f"  fwd kernel vs oracle: image/alpha {e:.3g}, depth {e_d:.3g}")
        check(e <= 2e-4 and e_d <= 1e-3 * drange, "kernel disagrees with the oracle")

    # splats aimed at the culls (the row spans and the kernels' warp boxes):
    # contours past 3σ at opacity 0.95-0.99, centres on warp corners, long
    # thin and bad-conic splats
    big = 512
    proj = make_cull_scene(2000, 5, width=big, height=big, device=dev)
    pairs = tiles.bin_pairs(proj, image_width=big, image_height=big)
    k = tiles.composite_tiles(pairs, image_height=big, image_width=big)
    p = tiles.composite_tiles_plain(pairs, image_height=big, image_width=big)
    torch.cuda.synchronize()
    n_bad = int((tiles.warp_extents(tiles.ellipse(proj))[:, 0] < 0).sum())
    what = f"cull scene: 2000 splats @ {big}², {n_bad} bad conics, {int(pairs.ranges[-1])} pairs"
    errs["composite_fwd"] = max(errs["composite_fwd"], compare_fwd(
        torch, k, p, float(proj.depth.max() - proj.depth.min()), what))
    same = float((k.last_pair == p.last_pair).float().mean())
    exact = all(torch.equal(getattr(k, f), getattr(p, f))
                for f in ("color", "depth", "alpha", "final_logt"))
    print(f"  last pair equal at {same:.6f} of pixels; outputs bit for bit: {exact}")
    check(same > 0.999, f"{what}: last pairs differ")
    errs["composite_bwd"] = max(errs["composite_bwd"], compare_bwd(
        torch, tiles, pairs, k, cotangents(torch, dev, big, big, 13), big, big, 1e-4, what))

    # one saturated tile: 600 near-opaque splats stacked in depth
    # (tests/test_pallas.py:144-152), at that file's 64² and camera
    n, small = 600, 64
    rng = np.random.RandomState(1)
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.randn(n, 2).astype(np.float32) * 0.015
    means[:, 2] = np.linspace(-0.4, 0.4, n)
    arrays = {"means": means, "scales": np.exp(rng.randn(n, 3).astype(np.float32) * 0.2 - 3.4),
              "rots": rng.randn(n, 4).astype(np.float32),
              "shs": rng.randn(n, 1, 3).astype(np.float32) * 0.3,
              "opacity": np.full((n,), 0.97, np.float32)}
    cam64 = make_camera(np.eye(3), np.array([0.0, 0, 3.0]), fx=150, fy=150, cx=small / 2,
                        cy=small / 2, width=small, height=small, device=dev)
    proj = project_arrays(cam64, arrays, small, small)
    pairs = tiles.bin_pairs(proj, image_width=small, image_height=small)
    out = tiles.composite_tiles_cuda(pairs, image_height=small, image_width=small)
    counts = pairs.ranges[1:] - pairs.ranges[:-1]
    check(int(counts.max()) > 256 and float(out.alpha.max()) > 0.9999, "tile not saturated")
    errs["composite_bwd"] = max(errs["composite_bwd"], compare_bwd(
        torch, tiles, pairs, out, cotangents(torch, dev, small, small, 7), small, small, 2e-4,
        f"saturated tile: 600 splats of opacity 0.97 @ {small}², deepest tile "
        f"{int(counts.max())} pairs"))

    # the backward kernel through autograd against autograd of the exact oracle
    proj = project_arrays(cam, make_splat_scene(3000, 3, max_opacity=0.35),
                          size, size)
    target = torch.as_tensor(np.random.RandomState(2).rand(3, size, size).astype(np.float32),
                             device=dev)
    grads = []
    for raster in ("kernel", "oracle"):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (proj.means2d, proj.conic, proj.rgb, proj.opacity, proj.depth)]
        p = proj._replace(means2d=leaves[0], conic=leaves[1], rgb=leaves[2],
                          opacity=leaves[3], depth=leaves[4])
        if raster == "kernel":
            img, depth, alpha, _ = tiles.rasterize_tiles(p, image_height=size, image_width=size,
                                                         bg=bg)
        else:
            img, depth, alpha = rasterize_reference(p, image_height=size, image_width=size,
                                                    bg=bg, pixel_chunk=4096)
        loss = ((img - target) ** 2).mean() + 0.1 * depth.mean() + 0.05 * (alpha ** 2).mean()
        grads.append(torch.autograd.grad(loss, leaves))
    rel = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(*grads))
    print(f"3000 splats, opacity <= 0.35 @ {size}²: autograd through the kernels vs through "
          f"the oracle, worst input {rel:.3g} x max (tolerance 1e-4)")
    check(rel <= 1e-4, "backward kernel disagrees with autograd of the oracle")
    return errs


def phase_bench_shape(torch, dev):
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.probes.scene import HEIGHT as h, WIDTH as w, bench_scene

    proj, pairs = bench_scene(dev)
    with torch.no_grad():
        k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
        p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
        live = proj.radii > 0
        compare_fwd(torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()),
                    f"bench.py shape, {proj.radii.numel()} splats @ {w}x{h}")
        cot = cotangents(torch, dev, h, w, 11)
        compare_bwd(torch, tiles, pairs, k, cot, h, w, 1e-4, f"bench.py shape @ {w}x{h}")
        time_both(torch, tiles, proj, pairs, k, cot, h, w, f"bench.py shape @ {w}x{h}")


def phase_inference(torch, dev, tmp, out_root):
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.doll import Simulation

    traj = os.path.join(tmp, "traj.pkl")
    t0 = time.perf_counter()
    info = write_inference_inputs(out_root, traj, nx=48, ny=48, texture_size=TEXTURE,
                                  sh_degree=SH_DEGREE, width=WIDTH, height=HEIGHT,
                                  n_frames=FRAMES)
    print(f"inference inputs written: {info['n_texels']} texel splats, "
          f"{time.perf_counter() - t0:.1f} s")
    render_dir = os.path.join(tmp, "render")
    argv = ["--traj_path", traj, "--output_path", render_dir, "--device", "cuda",
            "--texture_size", str(TEXTURE), "--sh_degree", str(SH_DEGREE),
            "--width", str(WIDTH), "--height", str(HEIGHT)]
    run_inference(torch, inference, argv, "inference path")

    args = inference.parse_args(argv)
    simu = Simulation(traj, render_dir, sh_degree=SH_DEGREE, texture_size=TEXTURE, device=dev)
    camera = inference.load_camera(simu.garment_names[0], args, dev)
    err = frame0_kernel_check(torch, simu, camera, "inference frame 0", framing=True)
    return traj, render_dir, argv, err


def frame0_kernel_check(torch, simu, camera, what, framing=False):
    """The forward kernel against its plain version on frame 0's bundle of
    ``simu``, timed beside its plain version and its bound; ``framing``
    also checks that the garment covers a third of the frame."""
    from gaussian_garments_tpu_torch.doll import concat_bundle
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
    from gaussian_garments_tpu_torch.probes.common import cuda_ms
    from gaussian_garments_tpu_torch.renderer import project

    with torch.no_grad():
        updates, vis = simu.forward(0, camera)
        face, _ = rasterize_mesh(updates[0]["mesh_v"], updates[0]["mesh_f"],
                                 camera.world_view_transform, camera.full_proj_transform,
                                 image_width=WIDTH, image_height=HEIGHT)
        framed = float((face >= 0).float().mean())
        if framing:
            check(framed >= 1 / 3, f"the garment covers {framed} of the frame, not a third")
        proj = project(camera, concat_bundle(updates, vis, SH_DEGREE, override="shs"))
        pairs = tiles.bin_pairs(proj, image_width=WIDTH, image_height=HEIGHT)
        kw = dict(image_height=HEIGHT, image_width=WIDTH)
        k = tiles.composite_tiles_cuda(pairs, **kw)
        p = tiles.composite_tiles_plain(pairs, **kw)
        live = proj.radii > 0
        counts = pairs.ranges[1:] - pairs.ranges[:-1]
        err = compare_fwd(torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()),
                          f"{what} @ {WIDTH}x{HEIGHT} (garment covers {framed:.3f}): "
                          f"{proj.means2d.shape[0]} splats, {int(vis.sum())} visible, "
                          f"{int(pairs.ranges[-1])} pairs, max {int(counts.max())} per tile")
        ms = cuda_ms(lambda: tiles.composite_tiles_cuda(pairs, **kw), 20)
        plain = cuda_ms(lambda: tiles.composite_tiles_plain(pairs, **kw), 1)
        wk = work(torch, proj, pairs, k, HEIGHT, WIDTH)
        bound, by, nbytes, terms = wk["composite_fwd"]
        print(f"  composite_fwd at this shape: kernel {ms:.4f} ms (CUDA events, mean "
              f"of 20), plain {plain:.2f} ms (mean of 1), bound {bound:.4f} ms by {by} "
              f"({nbytes} B, {terms} terms); pairs {wk['rect_pairs']} in the plain rect, "
              f"{wk['pairs']} after the row-span cull")
    return err


def compositor_launches(since=None) -> dict:
    """The compositor kernels' launches in this process, less ``since``."""
    from gaussian_garments_tpu_torch.ops import tiles

    now = tiles.launches()
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def traced_compositor_launches(torch, run):
    """``run()`` under the profiler's device trace: (its result, the
    compositor kernels that the trace shows ran on the card, by name). A
    replayed CUDA graph's kernels appear in the trace one by one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = run()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return result, {k: sum(f"{k}_kernel" in n for n in names)
                    for k in ("composite_fwd", "composite_bwd")}


def run_inference(torch, inference, argv, what):
    """``inference.main`` with the compositor's launches counted; checks the
    PNG rows and the coverage and prints the per-frame split."""
    import numpy as np
    from PIL import Image

    before = compositor_launches()
    t0 = time.perf_counter()
    stats = inference.main(argv)
    wall = time.perf_counter() - t0
    launches = compositor_launches(before)["composite_fwd"]
    out = argv[argv.index("--output_path") + 1]
    pngs = sorted(os.listdir(os.path.join(out, "renders")))
    check(len(pngs) == FRAMES, f"{what}: expected {FRAMES} PNGs, got {pngs}")
    for name in pngs:
        img = np.asarray(Image.open(os.path.join(out, "renders", name)))
        check(img.shape == (HEIGHT, 3 * WIDTH, 3), f"{what} {name}: shape {img.shape}")
        check(img.std() > 0, f"{what} {name}: constant image")
    check(all(np.isfinite(c) and c > 0 for c in stats["coverage"]),
          f"{what}: garment coverage {stats['coverage']}")
    check(launches >= 3 * FRAMES, f"{what}: composite_fwd launched {launches} times")
    print(f"{what}: {FRAMES} frames in {wall:.2f} s wall, composite_fwd launches "
          f"{launches}, coverage {[round(c, 3) for c in stats['coverage']]}")
    for i, t in enumerate(stats["frames"]):
        print(f"  frame {i}: " + " ".join(f"{k}={v:.3f}" for k, v in t.items()))
    print("  per-frame mean (s): " + " ".join(f"{k}={v:.3f}" for k, v in stats["mean"].items()))
    return stats, launches


def phase_inference_modes(torch, dev, tmp, out_root, traj, render_dir, argv):
    """``inference --exact_visibility`` on phase 6's inputs (its bakes are
    cached in ``render_dir``), with the exact-against-depth agreement of
    every frame and the ray cast timed at several chunk sizes on frame 0;
    then ``--dense_texels`` on a garment with inset UVs, its render held
    equal to the compact layout's. The forward kernel is held against its
    plain version on frame 0's bundle of each."""
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.doll import Simulation, concat_bundle, joint_visibility_depth
    from gaussian_garments_tpu_torch.ops import raytrace
    from gaussian_garments_tpu_torch.renderer import render

    errs = []
    stats, _ = run_inference(torch, inference, argv + ["--exact_visibility"],
                             "inference --exact_visibility")
    check(all(t["raycast_s"] > 0 for t in stats["frames"]), "the ray cast was not timed")
    args = inference.parse_args(argv)
    simu = Simulation(traj, render_dir, sh_degree=SH_DEGREE, texture_size=TEXTURE,
                      exact_visibility=True, device=dev)
    camera = inference.load_camera(simu.garment_names[0], args, dev)
    with torch.no_grad():
        for idx in range(FRAMES):
            updates, exact = simu.forward(idx, camera)
            depth = joint_visibility_depth(updates, camera.world_view_transform,
                                           camera.full_proj_transform)
            agree = float((exact == depth).float().mean())
            print(f"  frame {idx}: exact visibility {float(exact.float().mean()):.4f} of "
                  f"{exact.numel()} splats visible, depth test {float(depth.float().mean()):.4f}; "
                  f"agreement {agree:.4f}")
            check(0.5 < agree and float(exact.float().mean()) > 0.1,
                  f"frame {idx}: exact visibility {float(exact.float().mean())}, agreement {agree}")
        # the ray cast alone on frame 0's rays (one garment: the anchors)
        u = simu.forward(0, camera)[0][0]
        d = u["anchor"] - camera.camera_center[None]
        dirs = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        origins = camera.camera_center[None].expand_as(dirs)
        n_faces = u["mesh_f"].shape[0]
        cast = lambda chunk: raytrace.raycast(origins, dirs, u["mesh_v"], u["mesh_f"],
                                              budget=chunk * 12 * n_faces)[1]
        want = raytrace.raycast(origins, dirs, u["mesh_v"], u["mesh_f"])[1]
        for chunk in (256, 1024, 4096, 16384):
            cast(chunk)                                                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                got = cast(chunk)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"ray cast chunk {chunk} changed the hits")
            print(f"  ray cast, {dirs.shape[0]} rays x {n_faces} faces, chunk "
                  f"{chunk}: {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms (host clock around "
                  f"synchronize, mean of 3; default chunk {raytrace.chunk_rays(n_faces)})")
    errs.append(frame0_kernel_check(torch, simu, camera, "inference --exact_visibility frame 0"))

    inset_traj = os.path.join(tmp, "traj_inset.pkl")
    info = write_inference_inputs(out_root, inset_traj, name="garment_inset", nx=48, ny=48,
                                  texture_size=TEXTURE, sh_degree=SH_DEGREE, width=WIDTH,
                                  height=HEIGHT, n_frames=FRAMES, uv_inset=UV_INSET)
    print(f"inset garment (UVs in [{UV_INSET}, {1 - UV_INSET}]): {info['n_texels']} of "
          f"{TEXTURE * TEXTURE} texels alive")
    dense_dir = os.path.join(tmp, "render_dense")
    dense_argv = ["--traj_path", inset_traj, "--output_path", dense_dir] + argv[4:]
    run_inference(torch, inference, dense_argv + ["--dense_texels"], "inference --dense_texels")
    sims = {dense: Simulation(inset_traj, dense_dir, sh_degree=SH_DEGREE, texture_size=TEXTURE,
                              dense_texels=dense, device=dev) for dense in (False, True)}
    bg = torch.zeros(3, device=dev)
    frame0 = lambda sim: render(camera, concat_bundle(*sim.forward(0, camera), SH_DEGREE),
                                bg)["render"]
    with torch.no_grad():
        twice = [frame0(sims[False]) for _ in range(2)]
        print(f"  inference frame 0, compact layout, rendered twice with cuDNN's default "
              f"algorithms: equal bit for bit {torch.equal(*twice)}, max |difference| "
              f"{float((twice[0] - twice[1]).abs().max()):.3g}")
        with deterministic_cudnn(torch):
            images = {dense: frame0(sim) for dense, sim in sims.items()}
    same = torch.equal(images[True], images[False])
    print(f"  inference frame 0, dense against compact layout (cuDNN deterministic): equal bit "
          f"for bit: {same}")
    check(same, "the dense inference render differs from the compact one")
    errs.append(frame0_kernel_check(torch, sims[True], camera,
                                    "inference --dense_texels frame 0"))
    return max(errs)


def read_logs(path):
    """{frame file: [runs]}: each run is the loss entries that a run of the
    driver appended, ended by its save-point quality entry."""
    logs = {}
    for name in sorted(os.listdir(path)):
        runs, cur = [], []
        with open(os.path.join(path, name)) as f:
            for line in f:
                e = json.loads(line)
                if "frame" in e:
                    runs.append(cur)
                    cur = []
                else:
                    cur.append(e)
        logs[name] = runs
    return logs


def phase_s2(torch, dev, data_root, out_root):
    import numpy as np
    from gaussian_garments_tpu_torch import s2_registration
    from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout

    t0 = time.perf_counter()
    info = write_reference_layout(data_root, out_root, "subj", "seq", n_cams=S2_CAMS,
                                  n_frames=S2_FRAMES, nx=S2_NX, ny=S2_NX, width=WIDTH,
                                  height=HEIGHT, ring_radius=0.5, ring_height=2.0, cover=1.1,
                                  device=dev)
    n_faces = len(info["faces"])
    print(f"s2 data: {S2_CAMS} cameras at {WIDTH}x{HEIGHT}, {S2_FRAMES} frames, a "
          f"{S2_NX}x{S2_NX} sheet of {n_faces} faces, focal {info['fx']:.1f} px, garment "
          f"covers >= {info['min_coverage']:.3f} of every frame; "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_faces == 7938, f"{n_faces} faces")
    check(info["min_coverage"] >= 1 / 3, "the garment must cover a third of every frame")
    print(f"s2 iteration cuts: {S2_CUTS}")
    common = ["-s", "subj", "-q", "seq", "--eval", "--cameras_per_step", str(S2_PER_STEP),
              "--device", "cuda"]
    stage2 = os.path.join(out_root, "subj", "stage2")
    launches = {"composite_fwd": 0, "composite_bwd": 0}
    modes, quality = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for run, extra in (("template", S2_TEMPLATE), ("sequence", S2_SEQUENCE)):
        before = compositor_launches()
        t0 = time.perf_counter()
        stats = s2_registration.main(common + extra)
        wall = time.perf_counter() - t0
        fwd, bwd = compositor_launches(before).values()
        launches["composite_fwd"] += fwd
        launches["composite_bwd"] += bwd
        iters = sum(m["iterations"] for m in stats["modes"].values())
        print(f"s2 {run} run: {iters} iterations in {wall:.1f} s wall; launches "
              f"composite_fwd {fwd}, composite_bwd {bwd}")
        check(bwd >= S2_PER_STEP * iters and fwd >= S2_PER_STEP * iters
              and fwd + bwd >= 2 * S2_PER_STEP * iters,
              f"{run}: kernels launched {fwd} + {bwd} times for {iters} iterations")
        modes.update(stats["modes"])
        quality[run] = stats["frames"][-1]
    peak = torch.cuda.max_memory_allocated(dev)

    expect = [os.path.join("Template", f) for f in
              ("local_point_cloud.ply", "point_cloud.ply", "binding.pkl", "template.obj",
               "template_render.png")]
    expect += [os.path.join("seq", f) for f in ("cameras.json", "cfg_args", "input.ply")]
    for t in range(S2_FRAMES):
        expect += [os.path.join("seq", "meshes", f"frame_{t:05d}.obj"),
                   os.path.join("seq", "renders", f"{t:05d}.png"),
                   os.path.join("seq", "logs", f"frame_{t:05d}.jsonl")]
        expect += [os.path.join("seq", "point_cloud", f"frame_{t:05d}", f) for f in
                   ("local_point_cloud.ply", "point_cloud.ply", "binding.pkl")]
    missing = [f for f in expect if not os.path.exists(os.path.join(stage2, f))]
    check(not missing, f"missing s2 artifacts: {missing}")

    logs = read_logs(os.path.join(stage2, "seq", "logs"))
    check(sorted(len(runs) for runs in logs.values()) == [1, 2], f"log runs {logs}")
    for runs in logs.values():
        for e in (e for run in runs for e in run):
            vals = [v for k, v in e.items() if k not in ("step", "time")]
            check(all(np.isfinite(v) for v in vals), f"non-finite log entry {e}")
    # frame 0's log holds the template run, then the sequence run's frame 0.
    # The img loss must fall in the template run and in every sequence frame
    # with motion to track; sequence frame 0 starts at the true mesh (the
    # synthetic template is frame 0's mesh), so it is only reported.
    runs = [("template run", logs["frame_00000.jsonl"][0], True)]
    runs += [(f"sequence run, {name[:-6]}", r[-1], name != "frame_00000.jsonl")
             for name, r in logs.items()]
    for what, run, must_fall in runs:
        for e in run:
            if "n_clone" in e:
                print(f"{what}, densification at iteration {e['step']}: " + ", ".join(
                    f"{k} {e[k]:.6g}" for k in ("n_clone", "n_split", "n_prune", "n_alive",
                                               "grad_mean", "grad_max")))
        losses = [e for e in run if "img" in e]
        first, last = losses[0], losses[-1]
        print(f"{what}: img loss " + ", ".join(f"{e['img']:.5f} (iteration {e['step']})"
                                               for e in losses)
              + f"; splats {int(first['n_splats'])} -> {int(last['n_splats'])}")
        check(last["img"] < first["img"] or not must_fall, f"{what}: the img loss did not fall")
    check(int([e for e in runs[0][1] if "img" in e][-1]["n_splats"]) != n_faces,
          "densification did not change the splat count")

    for mode, m in modes.items():
        print(f"s2 {mode}: {m['iterations']} iterations, {m['s_per_iteration']:.4f} s/iteration "
              f"(host clock, each step ends in a synchronize)")
    # No PSNR floor: the template's splats start at world scale exp(NN log-scale)
    # x face scale (a reference quirk, models/mesh_gaussian.py), ~0.14 px here, and
    # 150 iterations at scaling_lr 0.005 can grow them at most e^0.75-fold.
    for run, q in quality.items():
        print(f"s2 {run} run, frame {q['frame']} at the save point: test PSNR "
              f"{q['test_psnr']:.3f} dB, SSIM {q['test_ssim']:.4f}; train PSNR "
              f"{q['train_psnr']:.3f} dB, SSIM {q['train_ssim']:.4f}; {q['n_splats']} splats")
        check(all(np.isfinite(q[k]) for k in ("test_psnr", "test_ssim", "train_psnr",
                                              "train_ssim")), f"{run}: quality {q}")
    print(f"s2 peak device memory: {peak / 2**30:.3f} GiB (max_memory_allocated)")
    return launches


def phase_s2_split(torch, dev, out_root):
    """Device split of one stage-2 iteration at full width, from the trained
    Template state and 4 of frame 0's cameras, each piece on the host clock
    around synchronize (mean of 5); then both kernels at that shape against
    their plain versions, timed."""
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.renderer import BatchedCameras, _project
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils.losses import ssim

    opt, state, cams = s2_template_state(torch, dev, out_root, "seq")
    cams = cams[1:1 + S2_PER_STEP]
    batch = BatchedCameras.from_cameras(cams)
    bg = torch.zeros(3, device=dev)
    w, h = batch.width, batch.height
    reps, ms = 5, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3 / reps
        return out

    steps = {m: S2.make_s2_step(opt, mode=m, use_body=m != "template_p1")
             for m in ("template_p1", "seq")}
    for m, step in steps.items():      # warm-up
        step(state, batch, bg, 1e-4, 1e-4)
    for _ in range(reps):
        leaves = {k: getattr(state.params, k).detach().requires_grad_(True) for k in G.PARAM_NAMES}
        p = G.GaussianParams(**leaves)
        bundle = timed("face frames + splat bundle", lambda: S2.splat_bundle(
            p, state.binding, state.aux.alive, state.mesh.v, state.mesh.f))
        for b in range(S2_PER_STEP):
            proj = timed(f"projection (x{S2_PER_STEP})", lambda: _project(
                bundle, batch.world_view[b], batch.full_proj[b], batch.campos[b], width=w,
                height=h, tanfovx=batch.tanfovx[b], tanfovy=batch.tanfovy[b],
                scaling_modifier=1.0, vis_mask=None, screen_offset=None))
            pairs = timed(f"binning (x{S2_PER_STEP})", lambda: tiles.bin_pairs(
                proj, image_width=w, image_height=h))
            out = timed(f"composite_fwd kernel (x{S2_PER_STEP})", lambda: tiles.composite_tiles_cuda(
                pairs, image_height=h, image_width=w))
            cot = cotangents(torch, dev, h, w, b)
            timed(f"composite_bwd kernel (x{S2_PER_STEP})", lambda: tiles.composite_tiles_backward_cuda(
                pairs, out.final_logt, out.last_pair, *cot, image_height=h, image_width=w))
        img = batch.image.clone().requires_grad_(True)
        timed("SSIM fwd+bwd (4 cameras)", lambda: torch.autograd.grad(
            ssim(img * 0.9, batch.image, batch.mask), img))
        v = state.mesh.v.detach().requires_grad_(True)
        timed("cloth energies fwd+bwd", lambda: torch.autograd.grad(sum(MM.get_energy_loss(
            state.mesh.replace(v=v), opt, False).values()), v))
        lrs = {k: 1e-4 for k in G.PARAM_NAMES}
        timed("Adam (splats)", lambda: G.adam_step(state.params, state.params, state.splat_adam,
                                                   lrs))
        for m, step in steps.items():
            timed(f"whole step, {m}", lambda: step(state, batch, bg, 1e-4, 1e-4))
    print(f"s2 device split of one iteration at {w}x{h}, {S2_PER_STEP} cameras, "
          f"{int(state.aux.alive.sum())} splats, ms (mean of {reps}, host clock around "
          f"synchronize):")
    for k, v in ms.items():
        print(f"  {k}: {v:.3f}")

    with torch.no_grad():
        proj = s2_project(torch, state, batch, 0)
        what = f"s2 shape, camera {cams[0].image_name} @ {w}x{h}"
        errs, pairs, k, cot = hold_kernels(torch, dev, proj, h, w, 5, what)
        timing = time_both(torch, tiles, proj, pairs, k, cot, h, w, what)
    return errs, timing, ms


def phase_probes(torch):
    """The probe kernels through the probes' entry points. Each run's kernels
    are held against their plain versions inside the run; their launch
    counts are zeroed just before the run and read just after."""
    from gaussian_garments_tpu_torch.probes import composite_null, gather, grid_overhead

    runs = [(f"gather probe, row {row}", gather, ["--rows", row]) for row in gather.ROWS]
    runs += [("composite_null probe", composite_null, []),
             ("grid_overhead probe", grid_overhead, [])]
    rows = []
    for what, module, argv in runs:
        for wrapper in module.WRAPPERS.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        out = module.main(argv + ["--device", "cuda", "--reps", str(PROBE_REPS)])
        torch.cuda.synchronize()
        for r in out if isinstance(out, list) else out["rows"]:
            r["launches"] = module.WRAPPERS[r["name"]].launches
            if module is gather:
                r["name"] = f"{r['name']}@{r['row']}"
            check(r["ok"], f"{what}: {r['name']} differs from its plain version by "
                           f"{r['max_abs_err']} (tolerance {r['tolerance']})")
            check(r["launches"] > 0, f"{what}: {r['name']} was not launched")
            rows.append(r)
        print(f"{what}: {time.perf_counter() - t0:.1f} s; launches " + ", ".join(
            f"{name} {w.launches}" for name, w in module.WRAPPERS.items() if w.launches))
        if module is grid_overhead:
            check_ladder_writes(out)
    return rows


def check_ladder_writes(out):
    """Each ladder variant's grid, and its writes of output tiles to global
    memory as the kernel counted them: one per tile that holds pairs, and
    for d one write of tile 0 a launch."""
    for r in out["rows"]:
        want = 1 if r["row"] == "d" else out["first_items"]
        print(f"grid_{r['row']}: grid {r['grid']} blocks of 256 threads for {out['n_items']} "
              f"items; {r['tile_writes']} output tiles written to global memory (want {want})")
        check(r["tile_writes"] == want, f"grid_{r['row']} wrote {r['tile_writes']} output tiles "
                                        f"to global memory, want {want}")


def s3_argv(subject="subj", *flags):
    """``s3_appearance``'s arguments for a run whose output root is
    ``<output>/<subject>`` (the data stay those of ``subj``)."""
    return S3_ARGS + ["-so", subject, *flags]


def copy_stage2(out_root, subject, uv_inset=None):
    """``<output>/subj`` less its stage 3, copied to ``<output>/<subject>``;
    with ``uv_inset`` the template's UVs are inset and the cached bakes
    dropped (they depend on the texel layout)."""
    import shutil
    from gaussian_garments_tpu_torch.data.synthetic import inset_uvs
    from gaussian_garments_tpu_torch.utils.io import read_obj, write_obj

    dst = os.path.join(out_root, subject)
    shutil.copytree(os.path.join(out_root, "subj"), dst,
                    ignore=lambda d, names: ["stage3"] if d == os.path.join(out_root, "subj")
                    else ["texture"] if uv_inset is not None else [])
    if uv_inset is not None:
        path = os.path.join(dst, "stage1", "template_uv.obj")
        template = read_obj(path)
        write_obj(dict(template, uvs=inset_uvs(template["uvs"], uv_inset)), path)
    return dst


def phase_s3(torch, dev, out_root, subject="subj", flags=()):
    """``s3_appearance.main`` on the stage-2 output root (see the module doc),
    or on a copy of it in ``<output>/<subject>`` with ``flags``, under the
    profiler's device trace. Returns (the compositors' launches counted
    from that trace, step seconds by kind, peak device memory in bytes);
    the trace's count must equal the launch counters'."""
    import numpy as np
    from gaussian_garments_tpu_torch import s3_appearance
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training.checkpoints import (
        avatar_net_state_from_jax, load_s3_ckpt, s3_state_from_jax)
    from gaussian_garments_tpu_torch.utils import logging as log

    what = " ".join(["s3", *flags])
    print(f"{what} cuts: {S3_CUTS}")
    before = compositor_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats, launches = traced_compositor_launches(
        torch, lambda: s3_appearance.main(s3_argv(subject, *flags)))
    wall = time.perf_counter() - t0
    counted = compositor_launches(before)
    peak = torch.cuda.max_memory_allocated(dev)
    steps = stats["steps"]
    n_steps = steps["pre"]["n"] + steps["full"]["n"]
    print(f"{what} run: {stats['n_items']} training items, {stats['n_texels']} texel splats, "
          f"{n_steps} steps in {wall:.1f} s wall; launches in the device trace " + ", ".join(
              f"{k} {v}" for k, v in launches.items()) + f"; counters {counted}; graph "
          f"captures {log.counters().get('s3_graph.capture', 0)}, replays "
          f"{log.counters().get('s3_graph.replay', 0)} in this process")
    check(n_steps == S3_STEPS and steps["pre"]["n"] == S3_PRE, f"{what} steps {steps}")
    check(launches["composite_bwd"] >= n_steps and launches["composite_fwd"] >= n_steps,
          f"{what}: kernels launched {launches} times for {n_steps} steps")
    check(launches == counted, f"{what}: the device trace shows {launches} launches, the "
          f"counters {counted}")

    stage3 = os.path.join(out_root, subject, "stage3")
    expect = [os.path.join("ckpt", f) for f in ("net.pkl", "optm.pkl", "info.txt")]
    expect += [os.path.join("logs", "train.jsonl"), os.path.join("debug", "e01_i000000.png"),
               os.path.join("debug", "e05_i000020.png")]
    missing = [f for f in expect if not os.path.exists(os.path.join(stage3, f))]
    check(not missing, f"missing {what} artifacts: {missing}")
    with open(os.path.join(stage3, "ckpt", "info.txt")) as f:
        check(f.read().strip() == "Epoch 5", "info.txt does not say Epoch 5")
    ck = load_s3_ckpt(stage3)
    state = s3_state_from_jax(ck, device=dev)
    net = AvatarNet(texture_size=TEXTURE, sh_degree=SH_DEGREE).to(dev)
    net.load_state_dict(avatar_net_state_from_jax(ck["net_params"], ck["net_buffers"]))
    n_params = sum(v.numel() for v in net.parameters())
    check(ck["epoch"] == 5 and ck["iteration"] == n_steps and state.net_adam.step == n_steps
          and state.splat_adam.step == n_steps - S3_PRE, "checkpoint counters")
    check(state.splats.xyz.shape == (stats["n_texels"], 3), "checkpoint splats")
    check(all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
              for v in state.net_params.values()),
          "non-finite or non-float32 net weights in the checkpoint")
    print(f"{what} checkpoint loads through the port: epoch {ck['epoch']}, iteration "
          f"{ck['iteration']}, AvatarNet {n_params} parameters, "
          f"{state.splats.xyz.shape[0]} splats")

    losses = stats["losses"]
    check(all(np.isfinite(v) for e in losses for k, v in e.items()
              if k not in ("epoch", "it", "kind")), f"non-finite {what} loss")
    per_epoch = [np.mean([e["img"] for e in losses if e["epoch"] == ep]) for ep in range(1, 6)]
    print(f"{what} img loss, mean per epoch: " + ", ".join(f"{v:.5f}" for v in per_epoch))
    check(per_epoch[-1] < per_epoch[0], f"{what}: the img loss did not fall")
    check(len(stats["eval"]) == 10, f"{what}: {len(stats['eval'])} evals")
    for q in stats["eval"]:
        check(all(np.isfinite(v) for v in q.values()), f"{what} eval {q}")
    for q in (stats["eval"][0], stats["eval"][-1]):
        print(f"{what} eval at epoch {q['epoch']}, step {q['step']}: " + " ".join(
            f"{k}={v:.4f}" for k, v in q.items() if k.startswith("eval_")))
    for kind, m in steps.items():
        print(f"{what} {kind} steps: {m['n']}, {m['seconds'] / m['n']:.4f} s/step (host clock "
              f"under the profiler's device trace, each step ends in a synchronize; item "
              f"loading not included)")
    print(f"{what} peak device memory: {peak / 2**30:.3f} GiB (max_memory_allocated)")
    return launches, {k: m["seconds"] / m["n"] for k, m in steps.items()}, peak


def phase_s3_split(torch, dev, argv=S3_ARGS):
    """Device split of one stage-3 step at full width, from the trained
    checkpoint and the first training item, each piece on the host clock
    around synchronize (mean of 5); then both kernels at that shape against
    their plain versions, timed. Returns (errors, kernel timing, split ms)."""
    from torch.func import functional_call
    from gaussian_garments_tpu_torch import s3_appearance
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models.adam import tree_adam_step
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.renderer import _project
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.utils.losses import ssim

    _, run = s3_appearance.prepare(argv)
    check(run.start_epoch == 6, "the s3 checkpoint did not resume")
    state, bind, mesh_f, net = run.state, run.bind, run.mesh_f, run.net
    item = run.make_item([run.dataset[0]])
    w, h, mesh_v = item.width, item.height, item.mesh_v[0]
    reps, ms = 5, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3 / reps
        return out

    steps = {kind: S3.make_s3_step(net, run.run_args, sh_degree=SH_DEGREE,
                                   train_gaussians=kind == "full") for kind in ("pre", "full")}
    for step in steps.values():      # warm-up
        step(state, bind, mesh_f, item)
    lrs = S3.splat_lrs(run.run_args)
    for _ in range(reps):
        params = {k: v.detach().requires_grad_(True) for k, v in state.net_params.items()}
        frames = MG.compute_face_frames(mesh_v, mesh_f)
        rows = MG.gather_frame_rows(frames, bind.binding, mesh_v, mesh_f)
        net_in = (item.ambient[0], item.normal[0], item.world_view[0], item.campos[0], bind,
                  mesh_v, mesh_f, frames)
        timed("AvatarNet (StyleUNet) fwd+bwd", lambda: torch.autograd.grad(functional_call(
            net, S3._cast_net_vars(net, (params, state.net_buffers)), net_in,
            {"rows": rows}).square().mean(), list(params.values()), allow_unused=True))
        timed("visibility (256² depth test)", lambda: AG.get_visible_mask_depth(
            bind, mesh_v, mesh_f, item.world_view[0], item.full_proj[0], image_width=256,
            image_height=256, rows=rows))
        with torch.no_grad():
            bundle, vis, _ = S3._s3_project(
                net, S3._cast_net_vars(net, (state.net_params, state.net_buffers)),
                state.splats, bind, mesh_f, item, 0, sh_degree=SH_DEGREE)
        proj = timed("projection", lambda: _project(
            bundle, item.world_view[0], item.full_proj[0], item.campos[0], width=w, height=h,
            tanfovx=item.tanfovx[0], tanfovy=item.tanfovy[0], scaling_modifier=1.0,
            vis_mask=vis, screen_offset=None))
        pairs = timed("binning", lambda: tiles.bin_pairs(proj, image_width=w, image_height=h))
        out = timed("composite_fwd kernel", lambda: tiles.composite_tiles_cuda(
            pairs, image_height=h, image_width=w))
        cot = cotangents(torch, dev, h, w, 3)
        timed("composite_bwd kernel", lambda: tiles.composite_tiles_backward_cuda(
            pairs, out.final_logt, out.last_pair, *cot, image_height=h, image_width=w))
        img = item.image.clone().requires_grad_(True)
        timed("SSIM fwd+bwd", lambda: torch.autograd.grad(ssim(img * 0.9, item.image,
                                                               item.mask), img))
        timed("Adam (net + splats)", lambda: (
            tree_adam_step(state.net_params, state.net_params, state.net_adam, 1e-4),
            G.adam_step(state.splats, state.splats, state.splat_adam, lrs)))
        for kind, step in steps.items():
            timed(f"whole step, {kind}", lambda: step(state, bind, mesh_f, item))
    print(f"s3 device split ({' '.join(argv[len(S3_ARGS):]) or 'f32'}) of one step at "
          f"{w}x{h}, {run.n_texels} texel splats, "
          f"{int(vis.sum())} visible, {int(pairs.ranges[-1])} pairs, ms (mean of {reps}, host "
          f"clock around synchronize):")
    for k, v in ms.items():
        print(f"  {k}: {v:.3f}")

    with torch.no_grad():
        what = f"s3 shape, camera {run.dataset[0]['camera'].image_name} @ {w}x{h}"
        errs, pairs, k, cot = hold_kernels(torch, dev, proj, h, w, 5, what)
        timing = time_both(torch, tiles, proj, pairs, k, cot, h, w, what)
    return errs, timing, ms


def phase_s3_bf16(torch, dev, out_root, f32_run, f32_split):
    """``s3_appearance --unet_bf16`` on a copy of phase 7's output, checked as
    phase 8, and its device split beside the float32 one; then the float32
    run's checkpoint rendered on a held-out item by the float32 and by the
    bf16 net, all of its output and each part apart (``bf16_render_split``),
    and the scene of the JAX package's bf16 record (``bf16_record_scene``).
    Gates: on the trained checkpoint the bf16 ΔSH alone within 40 dB of the
    float32 render, and the bf16 Δxyz alone within 1 dB of the whole bf16
    render (the rest of the gap is Δxyz's rounding, which moves each splat by
    up to its error; on a trained state the JAX package's bf16 render is as
    far from its float32 render, ``tests/torch_bf16_trained.py``); on the
    record scene the whole bf16 render within 40 dB."""
    import numpy as np
    from gaussian_garments_tpu_torch import s3_appearance

    copy_stage2(out_root, "subj_bf16")
    launches, secs, peak = phase_s3(torch, dev, out_root, "subj_bf16", ("--unet_bf16",))
    errs, _, split = phase_s3_split(torch, dev, s3_argv("subj_bf16", "--unet_bf16"))
    unet = "AvatarNet (StyleUNet) fwd+bwd"
    print(f"s3 bf16 against f32: s/step pre {secs['pre']:.4f} / {f32_run[1]['pre']:.4f}, full "
          f"{secs['full']:.4f} / {f32_run[1]['full']:.4f}; StyleUNet fwd+bwd {split[unet]:.3f} / "
          f"{f32_split[unet]:.3f} ms; whole step pre {split['whole step, pre']:.3f} / "
          f"{f32_split['whole step, pre']:.3f}, full {split['whole step, full']:.3f} / "
          f"{f32_split['whole step, full']:.3f} ms; peak device memory {peak / 2**30:.3f} / "
          f"{f32_run[2] / 2**30:.3f} GiB")

    _, run = s3_appearance.prepare(S3_ARGS)
    check(run.start_epoch == 6, "the float32 s3 checkpoint did not resume")
    item = run.make_item([run.dataset.eval_item(0)])
    q = bf16_render_split(torch, run.net, run.state, run.bind, run.mesh_f, item, native=True)
    scale = float(torch.exp(run.state.splats.scaling).max(dim=1).values.median())
    print(f"s3 render of held-out item {item.width}x{item.height} from the float32 run's "
          f"checkpoint, bf16 net against float32 net: PSNR {q['bf16']['psnr']:.2f} dB, SSIM "
          f"{q['bf16']['ssim']:.5f}; its Δxyz alone {q['dxyz']['psnr']:.2f} dB, its ΔSH alone "
          f"{q['dsh']['psnr']:.2f} dB")
    errs_of = lambda sfx: (f"Δxyz max {q['dxyz_err_max' + sfx]:.4g}, relative "
                           f"{q['dxyz_err_rel' + sfx]:.4g}; ΔSH max {q['dsh_err_max' + sfx]:.4g}, "
                           f"relative {q['dsh_err_rel' + sfx]:.4g}")
    print(f"  texel rows: |Δxyz| mean {q['dxyz_mean']:.4g}, max {q['dxyz_max']:.4g} (splats' "
          f"largest local scale, median {scale:.4g}); bf16 error of {errs_of('')}; the bf16 "
          f"net without cuDNN: " + (errs_of("_native") if "dxyz_err_max_native" in q
                                    else "not measured"))
    check(all(np.isfinite(q[k]["psnr"]) for k in ("bf16", "dxyz", "dsh")),
          "non-finite bf16 PSNR")
    check(q["dsh"]["psnr"] >= 40.0,
          f"the bf16 ΔSH alone only {q['dsh']['psnr']} dB from the float32 render")
    check(abs(q["dxyz"]["psnr"] - q["bf16"]["psnr"]) <= 1.0,
          f"the bf16 Δxyz alone {q['dxyz']['psnr']} dB, the whole bf16 output "
          f"{q['bf16']['psnr']} dB: not Δxyz's gap")
    q = bf16_record_scene(torch, dev)
    print(f"s3 render of the JAX record's scene (scripts/quality_check.py: seeded float32 "
          f"weights, splats at log-scale -6.5, {WIDTH}x{HEIGHT}): bf16 net against float32 net "
          f"PSNR {q['psnr']:.2f} dB, SSIM {q['ssim']:.5f} (JAX on the TPU: 48.1 dB)")
    check(q["psnr"] >= 40.0, f"bf16 render only {q['psnr']} dB from the float32 render")
    return launches, errs


def bf16_render_split(torch, net, state, bind, mesh_f, item, native=False):
    """The eval render of ``item`` (one row) from ``state``'s weights with the
    float32 net's shadow texture against renders with the bf16 net's: all of
    it (``bf16``), only its Δxyz channels (``dxyz``: ΔSH the float32 net's),
    only its ΔSH channels (``dsh``); ``image_metrics`` of each against the
    float32 render. Also the texel rows' Δxyz and ΔSH, float32, and their
    bf16 error (largest, and the norm of the error over the norm of the
    value); with ``native`` the same errors of the bf16 net run without cuDNN
    (PyTorch's own CUDA convolutions), as ``*_native``."""
    from torch.func import functional_call
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.utils.quality import image_metrics

    class FixedTexture(torch.nn.Module):
        act_dtype = torch.float32

        def __init__(self, tex):
            super().__init__()
            self.tex = tex

        def forward(self, *args, **kwargs):
            return self.tex

    net_bf16 = AvatarNet(texture_size=net.texture_size, sh_degree=net.sh_degree,
                         act_dtype=torch.bfloat16).to(item.image.device)
    mesh_v = item.mesh_v[0]
    frames = MG.compute_face_frames(mesh_v, mesh_f)
    rows = MG.gather_frame_rows(frames, bind.binding, mesh_v, mesh_f)
    net_in = (item.ambient[0], item.normal[0], item.world_view[0], item.campos[0], bind, mesh_v,
              mesh_f, frames)
    shadow = lambda n: functional_call(n, S3._cast_net_vars(n, (state.net_params,
                                                                state.net_buffers)),
                                       net_in, {"rows": rows})
    with torch.no_grad():
        a, b = shadow(net), shadow(net_bf16)
        mixes = {"f32": a, "bf16": b, "dxyz": torch.cat([b[:3], a[3:]]),
                 "dsh": torch.cat([a[:3], b[3:]])}
        blank = state.replace(net_params={}, net_buffers={})
        renders = {k: S3.make_s3_eval(FixedTexture(t), sh_degree=net.sh_degree)(
            blank, bind, mesh_f, item)[0] for k, t in mixes.items()}
        ref = torch.clamp(renders.pop("f32"), 0, 1)
        out = {k: image_metrics(r, ref) for k, r in renders.items()}
        texels = {"": b}
        if native:
            try:
                with torch.backends.cudnn.flags(enabled=False):
                    texels["_native"] = shadow(net_bf16)
            except RuntimeError as e:    # a reading, not a check: say why it is missing
                print(f"  the bf16 net without cuDNN did not run: {e}")
        a = AG.gather_texture(bind, a)
        out["dxyz_mean"], out["dxyz_max"] = float(a[:, :3].abs().mean()), float(a[:, :3].abs().max())
        for suffix, t in texels.items():
            e = AG.gather_texture(bind, t) - a
            for name, c in (("dxyz", slice(0, 3)), ("dsh", slice(3, None))):
                out[f"{name}_err_max{suffix}"] = float(e[:, c].abs().max())
                out[f"{name}_err_rel{suffix}"] = float(e[:, c].norm() / a[:, c].norm())
    return out


def bf16_record_scene(torch, dev):
    """The scene of the JAX package's bf16 record (``scripts/quality_check.py``,
    ``psnr_unet_bf16_vs_f32``): a 48×48 sheet from its first camera, texture
    512, SH 3, splats at log-scale −6.5 and opacity sigmoid(2), the StyleUNet
    with seeded float32 weights; the bf16 net's render against the float32
    net's."""
    import numpy as np
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.data.baker import bake_textures
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    cams, verts, faces, uvs, _ = syn.make_scene(n_cams=1, nx=48, ny=48, width=WIDTH,
                                                height=HEIGHT, device=dev)
    bind, _ = AG.build_binding(uvs, faces, TEXTURE, device=dev)
    n = bind.binding.shape[0]
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    splats = G.GaussianParams(
        xyz=t(np.zeros((n, 3))), features_dc=t(rng.randn(n, 1, 3) * 0.1),
        features_rest=t(np.zeros((n, (SH_DEGREE + 1) ** 2 - 1, 3))),
        scaling=t(np.full((n, 3), -6.5)), rotation=t(np.tile([[1.0, 0, 0, 0]], (n, 1))),
        opacity=t(np.full((n, 1), 2.0)))
    amb, nrm = bake_textures(bind, verts, faces, n_samples=8)
    mesh_f = torch.as_tensor(faces, device=dev)
    c = cams[0]
    with torch.no_grad():
        vis = AG.get_visible_mask_depth(bind, t(verts), mesh_f, c.world_view_transform,
                                        c.full_proj_transform, image_width=256,
                                        image_height=256)
    item = S3.S3Item(
        image=c.original_image[None], mask=c.gt_alpha_mask[None], bg=t(np.zeros((1, 3))),
        mesh_v=t(verts[None]), ambient=t(amb[None]), normal=t(nrm[None]),
        world_view=c.world_view_transform[None], full_proj=c.full_proj_transform[None],
        campos=c.camera_center[None], tanfovx=(c.tanfovx,), tanfovy=(c.tanfovy,),
        vis=vis[None].to(torch.float32), width=WIDTH, height=HEIGHT)
    net = AvatarNet(texture_size=TEXTURE, sh_degree=SH_DEGREE,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    return bf16_render_split(torch, net, S3.init_state(net, splats), bind, mesh_f, item)[
        "bf16"]


def phase_s3_dense(torch, dev, out_root):
    """``s3_appearance --dense_texels`` on a copy of phase 7's output with its
    UVs inset (``UV_INSET``), checked as phase 8; then from that checkpoint,
    in both layouts, on the first training item with cuDNN deterministic
    (``deterministic_cudnn``): the render and every tile's pair count equal
    bit for bit, one step's losses within 1e-4·|loss| + 1e-6; the whole step
    timed (mean of 5, default cuDNN), and both kernels against their plain
    versions at that shape."""
    import numpy as np
    from gaussian_garments_tpu_torch import s3_appearance
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.renderer import _project
    from gaussian_garments_tpu_torch.training import s3 as S3

    copy_stage2(out_root, "subj_inset", uv_inset=UV_INSET)
    launches, secs, peak = phase_s3(torch, dev, out_root, "subj_inset", ("--dense_texels",))
    runs = {dense: s3_appearance.prepare(s3_argv("subj_inset", *(
        ["--dense_texels"] if dense else [])))[1] for dense in (False, True)}
    items = {}
    for dense, run in runs.items():
        np.random.seed(0)                  # the same random background for both
        items[dense] = run.make_item([run.dataset[0]])
    alive = runs[True].bind.alive
    print(f"s3 inset scene: {int(alive.sum())} of {alive.numel()} texels alive")
    check(torch.equal(items[True].vis[0][alive], items[False].vis[0]),
          "dense visibility differs at alive texels")
    out, ms, losses = {}, {}, {}
    reps = 5
    for dense, run in runs.items():
        item, state, net = items[dense], run.state, run.net
        w, h = item.width, item.height
        step = S3.make_s3_step(net, run.run_args, sh_degree=SH_DEGREE, train_gaussians=True)
        with deterministic_cudnn(torch):
            with torch.no_grad():
                bundle, vis, _ = S3._s3_project(net, (state.net_params, state.net_buffers),
                                                state.splats, run.bind, run.mesh_f, item, 0,
                                                sh_degree=SH_DEGREE)
                proj = _project(bundle, item.world_view[0], item.full_proj[0], item.campos[0],
                                width=w, height=h, tanfovx=item.tanfovx[0],
                                tanfovy=item.tanfovy[0], scaling_modifier=1.0, vis_mask=vis,
                                screen_offset=None)
                pairs = tiles.bin_pairs(proj, image_width=w, image_height=h)
                render = S3.make_s3_eval(net, sh_degree=SH_DEGREE)(state, run.bind, run.mesh_f,
                                                                  item)
            losses[dense] = {k: float(v) for k, v in
                             step(state, run.bind, run.mesh_f, item)[1].items()}
        out[dense] = (proj, pairs, render)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(state, run.bind, run.mesh_f, item)
        torch.cuda.synchronize()
        ms[dense] = (time.perf_counter() - t0) * 1e3 / reps
    counts = {d: o[1].ranges[1:] - o[1].ranges[:-1] for d, o in out.items()}
    same_pairs = torch.equal(counts[True], counts[False])
    same_render = torch.equal(out[True][2], out[False][2])
    cam_name = runs[True].dataset[0]["camera"].image_name
    print(f"s3 dense against compact, inset scene, item {cam_name} (cuDNN deterministic): pairs {int(out[True][1].ranges[-1])} / "
          f"{int(out[False][1].ranges[-1])}, per-tile counts equal {same_pairs}, render equal bit "
          f"for bit {same_render}; whole full step (default cuDNN) "
          f"{ms[True]:.3f} / {ms[False]:.3f} ms (mean of {reps}, host clock around synchronize); "
          f"driver s/step pre {secs['pre']:.4f}, full {secs['full']:.4f}, peak "
          f"{peak / 2**30:.3f} GiB")
    for k, a in losses[False].items():
        b = losses[True][k]
        print(f"  {k}: dense {b:.7g}, compact {a:.7g}")
        check(abs(a - b) <= 1e-4 * abs(a) + 1e-6, f"dense {k} loss {b} against compact {a}")
    check(same_pairs and same_render, "the dense render differs from the compact one")
    proj, pairs, _ = out[True]
    w, h = items[True].width, items[True].height
    with torch.no_grad():
        k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
        p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
        live = proj.radii > 0
        what = f"s3 --dense_texels shape @ {w}x{h}"
        errs = {"composite_fwd": compare_fwd(
            torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()), what)}
        errs["composite_bwd"] = compare_bwd(torch, tiles, pairs, k, cotangents(
            torch, dev, h, w, 9), h, w, 1e-4, what)
    check(np.isfinite(list(errs.values())).all(), "non-finite kernel errors")
    return launches, errs


DP_WORLD, DP_TIMEOUT = 2, 420
S2_DP_TEMPLATE = ["-tf", "0", "--first_frame_iterations", "4", "--ff_collision_iteration", "2",
                  "--densify_from_iter", "100", "--eval", "--cameras_per_step",
                  str(S2_PER_STEP)]
S3_DP_FLAGS = ["--items_per_step", "2", "--ckpt_backend", "orbax"]
# the s3 driver pair's parts at the median, as shares of what the entries moved
# (tests/test_torch_data_parallel.py holds its 2-rank pair to the same)
DRIVER_MEDIAN_PART = {"net": 0.2, "splats": 0.5}


def within_adam_step(d, lr, what):
    """A one-step difference of the net's parameters held by Adam's rule:
    Adam moves every entry by up to lr whatever the size of its gradient, so
    a near-zero gradient summed in another order (the backward kernel's
    atomics, the ranks' partial means) can flip a step by 2·lr. Such flips
    stay rare: 99% of the entries within 1% of lr."""
    check(d["q99"] <= 0.01 * lr,
          f"{what}: 99% of the entries within {d['q99']:.3g} (largest difference "
          f"{d['abs']:.3g}), lr {lr:.3g}")


def dp_s2_case(torch, dev, out_root, path):
    """The trained Template state, 4 of frame 0's cameras and a body 5 mm
    under the sheet, as a case file for ``rank_checks.s2_steps``."""
    import pickle
    from pathlib import Path

    import numpy as np
    from gaussian_garments_tpu_torch.parallel import rank_checks
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import FrameDataloader
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.s2_registration import parse_args
    from gaussian_garments_tpu_torch.scene import bind_collision_faces
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.training.checkpoints import s2_state_to_jax
    from gaussian_garments_tpu_torch.utils.io import read_obj

    args, _, _ = parse_args(["-s", "subj", "-q", "seq"])
    root = Path(out_root) / "subj"
    args.subject_out = root
    cams = FrameDataloader(args, device=dev).load_frame(0)[1:1 + S2_PER_STEP]
    tmpl = root / DEFAULTS.stage2 / "Template"
    params, aux = G.load_ply(str(tmpl / "local_point_cloud.ply"), 0, device=dev)
    with open(tmpl / "binding.pkl", "rb") as f:
        binding = pickle.load(f)
    tem = read_obj(root / DEFAULTS.stage1 / "template_uv.obj")
    v = read_obj(tmpl / "template.obj")["vertices"]
    body_v = v - np.float32([0, 0, 0.005])
    mesh = MM.init_body(MM.create(v, tem["faces"], device=dev), body_v, tem["faces"],
                        bind_collision_faces(v, body_v, tem["faces"]))
    state = S2.init_state(params, aux, binding, mesh)
    np_ = lambda x: x.detach().cpu().numpy()
    c = {"world_view": np.stack([np_(x.world_view_transform) for x in cams]),
         "full_proj": np.stack([np_(x.full_proj_transform) for x in cams]),
         "campos": np.stack([np_(x.camera_center) for x in cams]),
         "image": np.stack([np_(x.original_image) for x in cams]),
         "mask": np.stack([np_(x.gt_alpha_mask) for x in cams]),
         "tanfovx": [x.tanfovx for x in cams], "tanfovy": [x.tanfovy for x in cams],
         "width": cams[0].image_width, "height": cams[0].image_height}
    lr = 1.6e-4
    case = dict(state=s2_state_to_jax(state), cams=c, bg=np.zeros(3, np.float32), xyz_lr=lr,
                vert_lr=lr)
    return rank_checks.write_case(path, **case), case, int(state.aux.alive.sum())


def phase_data_parallel(torch, dev, out_root):
    """(a) The data-parallel steps of both stages on 2 gloo ranks, new
    processes on the one card (NCCL refuses two ranks on one GPU; gloo stages
    CUDA tensors through the host): s2's three modes at the full-width
    Template state, each rank 2 of 4 cameras, and s3's two step kinds at
    texture 512, SH 3, the full StyleUNet, each rank 1 of 2 items; each held
    against the one-process step on all of the batch, and the ranks equal
    bit for bit after 3 steps. (b) The drivers under ``torch.distributed.run
    --nproc_per_node 1`` with ``--data_parallel`` (NCCL), held against the
    same run without it: an s2 template run of 6 iterations, and s3's epoch 5
    from a checkpoint at epoch 4 with 2 items a step and ``--ckpt_backend
    orbax``. Returns the compositor launches of the ranks."""
    import numpy as np
    from gaussian_garments_tpu_torch import graft_entry, parallel, s3_appearance
    from gaussian_garments_tpu_torch.parallel import rank_checks
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.training.checkpoints import s3_state_to_jax

    work = tempfile.mkdtemp(prefix="dp_", dir=out_root)
    launches = {"composite_fwd": 0, "composite_bwd": 0}
    t_phase = time.perf_counter()

    # (a) stage 2
    t0 = time.perf_counter()
    modes = (("template_p1", False), ("template_p2", True), ("seq", False))
    path, case, n_splats = dp_s2_case(torch, dev, out_root, os.path.join(work, "s2.pkl"))
    single = rank_checks.s2_steps(path, modes, 1, dev.type)
    case["reference"] = {m: single[m]["states"][0] for m, _ in modes}
    rank_checks.write_case(path, **case)
    ranks = parallel.spawn(rank_checks.s2_steps, DP_WORLD, (path, modes, 3, dev.type, False),
                           device=dev.type, timeout=DP_TIMEOUT)
    print(f"dp s2: {DP_WORLD} gloo ranks on {dev.type}, {S2_PER_STEP // 2} "
          f"of {S2_PER_STEP} cameras each at {case['cams']['width']}x{case['cams']['height']}, "
          f"{n_splats} splats, {len(case['state']['mesh']['f'])} faces; "
          f"{time.perf_counter() - t0:.1f} s")
    for r in ranks:
        print(f"dp s2 rank launches: " + ", ".join(f"{k} {v}" for k, v in r["launches"].items()))
        check(dev.type != "cuda" or all(v >= 3 * 3 * S2_PER_STEP // 2
                                        for v in r["launches"].values()),
              f"dp s2: a rank launched {r['launches']}")
        for k in launches:
            launches[k] += r["launches"][k]
    for mode, _ in modes:
        r0, ref = ranks[0][mode], single[mode]
        d = r0["diffs"]
        loss, want = r0["metrics"][0]["loss"], ref["metrics"][0]["loss"]
        print(f"dp s2 {mode}: loss {loss:.7g} (one process {want:.7g}); max |diff| after one "
              "step: " + ", ".join(f"{k} {d[k]['abs']:.3g}" for k in
                                   ("v", "params.xyz", "aux.xyz_gradient_accum", "aux.denom",
                                    "aux.max_radii2d")))
        check(abs(loss - want) <= 1e-4 * abs(want), f"dp s2 {mode}: loss {loss} vs {want}")
        check(r0["losses"][0].keys() == ref["losses"][0].keys(), f"dp s2 {mode}: loss terms")
        check(mode != "template_p2" or "collision" in r0["losses"][0], "no collision term")
        # the JAX tests' atol on the vertices and the splats' xyz
        check(d["v"]["abs"] <= 1e-6 and d["params.xyz"]["abs"] <= 1e-6,
              f"dp s2 {mode}: vertices or xyz differ by more than 1e-6")
        check(d["aux.xyz_gradient_accum"]["excess"] <= 1e-7, f"dp s2 {mode}: accumulators")
        check(d["aux.denom"]["abs"] == 0 and d["aux.max_radii2d"]["abs"] == 0,
              f"dp s2 {mode}: visibility counts or radii")
        check(r0["digest"] == ranks[1][mode]["digest"] and r0["losses"] == ranks[1][mode]["losses"],
              f"dp s2 {mode}: the ranks differ after 3 steps")
        check(all(np.isfinite(x) for e in r0["losses"] for x in e.values()), "dp s2 loss")
    print("dp s2: the ranks' states equal bit for bit after 3 steps of each mode")

    # (a) stage 3
    t0 = time.perf_counter()
    # a fresh state (an empty --ckpt_path): on the trained checkpoint the splats'
    # gradients sit at the backward's noise floor (on an H100, two one-process
    # steps differed by 15% of the largest xyz gradient), where no reduction
    # error could show
    _, run = s3_appearance.prepare(S3_ARGS + ["--ckpt_path", os.path.join(work, "fresh")])
    check(run.start_epoch == 1, "dp s3: the state did not start fresh")
    item = run.make_item([run.dataset[0], run.dataset[1]])
    np_ = lambda x: x.detach().cpu().numpy()
    it = {k: np_(getattr(item, k)) for k in ("image", "mask", "bg", "mesh_v", "ambient",
                                             "normal", "world_view", "full_proj", "campos",
                                             "vis")}
    it.update(tanfovx=list(item.tanfovx), tanfovy=list(item.tanfovy), width=item.width,
              height=item.height)
    from gaussian_garments_tpu_torch.utils.io import read_obj
    from gaussian_garments_tpu_torch.config import DEFAULTS
    tem = read_obj(os.path.join(out_root, "subj", DEFAULTS.stage1, "template_uv.obj"))
    tree = s3_state_to_jax(run.state)
    state_tree = {k: tree[k] for k in ("net_params", "net_buffers", "splats")}
    # deterministic cuDNN: its default transposed convolution sums in a
    # run-dependent order, which would blur the one-process spread. (A rank
    # that runs cuDNN in TF32, a new process's default, puts its loss 1.3e-4
    # off: parallel.spawn pins full float32 in each.)
    s3_case = dict(state=state_tree, item=it, uvs=tem["uvs"], faces=tem["texture_faces"],
                   texture_size=TEXTURE, sh_degree=SH_DEGREE, vis_hw=(256, 256),
                   args={"lr_init": run.run_args.lr_init}, cudnn_deterministic=True)
    check(np.array_equal(tem["texture_faces"], run.mesh_f.cpu().numpy()), "texture faces")
    del run, item, tree
    path3 = rank_checks.write_case(os.path.join(work, "s3.pkl"), **s3_case)
    kinds = ("pre", "full")
    single3 = rank_checks.s3_steps(path3, kinds, 1, dev.type)
    s3_case["reference"] = {k: single3[k]["states"][0] for k in kinds}
    rank_checks.write_case(path3, **s3_case)
    del s3_case
    ranks3 = parallel.spawn(rank_checks.s3_steps, DP_WORLD, (path3, kinds, 3, dev.type, False),
                            device=dev.type, timeout=DP_TIMEOUT)
    print(f"dp s3: {DP_WORLD} gloo ranks, 1 of 2 items each, texture {TEXTURE}, SH {SH_DEGREE}; "
          f"{time.perf_counter() - t0:.1f} s")
    lrs = S3.splat_lrs(graft_entry.default_opt())
    for r in ranks3:
        print(f"dp s3 rank launches: " + ", ".join(f"{k} {v}" for k, v in r["launches"].items())
              + f"; all-reduce of the step's gradient tree (gloo, CUDA tensors through the host) "
              f"{r['allreduce_ms']:.2f} ms (mean of 5)")
        check(dev.type != "cuda" or all(v >= 2 * 3 for v in r["launches"].values()),
              f"dp s3: a rank launched {r['launches']}")
        for k in launches:
            launches[k] += r["launches"][k]
    for kind in kinds:
        r0, ref = ranks3[0][kind], single3[kind]
        d = r0["diffs"]
        loss, want = sum(r0["losses"][0].values()), sum(ref["losses"][0].values())
        first = sorted(k for k in d if k.startswith("net."))[0]
        print(f"dp s3 {kind}: loss {loss:.7g} (one process {want:.7g}); max |diff| after one "
              f"step: net {d['net']['abs']:.3g} (99% within {d['net']['q99']:.3g}; first leaf "
              f"{d[first]['abs']:.3g}), " + ", ".join(
                  f"{k} {d['splats.' + k]['abs']:.3g} (99% within "
                  f"{d['splats.' + k]['q99']:.3g}; gradient "
                  f"{d['splat_mu.' + k]['abs']:.3g} of {d['splat_mu.' + k]['ref_max']:.3g})"
                  for k in lrs))
        check(abs(loss - want) <= 1e-4 * abs(want), f"dp s3 {kind}: loss {loss} vs {want}")
        # every net leaf by Adam's rule, the first too: the JAX test's 1e-5 on
        # the first leaf does not hold on the card, where that leaf is a bias
        # whose near-zero gradient can flip a step (0.001 = 2·lr)
        within_adam_step(d["net"], 5e-4, f"dp s3 {kind} net")
        # the splats by their gradient, Adam's first moment: rtol 1e-4 and atol
        # 1e-4 × its largest entry (the tests' port-against-JAX tolerance)
        for k in lrs:
            m = d["splat_mu." + k]
            check(m["excess"] <= 1e-4 * m["ref_max"],
                  f"dp s3 {kind} {k}: gradient off by {m['excess']:.3g} beyond rtol 1e-4, "
                  f"the largest {m['ref_max']:.3g}")
        check(r0["digest"] == ranks3[1][kind]["digest"], f"dp s3 {kind}: the ranks differ")
    print("dp s3: the ranks' states equal bit for bit after 3 steps of each kind")

    # (b) the drivers under torch.distributed.run, NCCL
    dp_drivers(torch, dev, out_root, "nccl" if dev.type == "cuda" else "gloo", state_tree)
    print(f"dp: launches by the ranks composite_fwd {launches['composite_fwd']}, composite_bwd "
          f"{launches['composite_bwd']}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def torchrun(module, argv, what, backend):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    module argv``; fails the run unless it exits 0 and prints the backend."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", module, *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=DP_TIMEOUT)
    check(res.returncode == 0, f"{what}: exit {res.returncode}\n{res.stdout[-2000:]}\n"
          f"{res.stderr[-4000:]}")
    check(f"[data parallel] backend {backend}, world size 1" in res.stdout,
          f"{what}: no {backend} group\n{res.stdout[-2000:]}")
    print(f"{what}: exit 0 in {time.perf_counter() - t0:.1f} s; [data parallel] backend "
          f"{backend}, world size 1")
    return res.stdout


def dp_drivers(torch, dev, out_root, backend, fresh):
    """(b) of ``phase_data_parallel``. ``fresh``: the net and splats of a
    fresh stage-3 state (numpy trees), from which the s3 runs start."""
    import json

    import numpy as np
    from gaussian_garments_tpu_torch import graft_entry, s2_registration, s3_appearance
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.training.checkpoints import load_s3_ckpt, save_s3_ckpt
    from gaussian_garments_tpu_torch.training.s3 import splat_lrs
    from gaussian_garments_tpu_torch.utils.io import read_obj

    # s2: a template run as one process and under torchrun
    for subject in ("subj_s2a", "subj_s2b"):
        shutil.copytree(os.path.join(out_root, "subj", "stage1"),
                        os.path.join(out_root, subject, "stage1"))
    argv = lambda subject: ["-s", "subj", "-q", "seq", "-so", subject, *S2_DP_TEMPLATE,
                            "--device", dev.type]
    stats = s2_registration.main(argv("subj_s2a"))
    torchrun("gaussian_garments_tpu_torch.s2_registration", argv("subj_s2b") + ["--data_parallel"],
             "dp s2 driver under torch.distributed.run", backend)
    a, b = (os.path.join(out_root, s, "stage2") for s in ("subj_s2a", "subj_s2b"))
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                             for f in fs)
    check(files(a) == files(b), f"dp s2 driver artifacts differ: {files(a)} vs {files(b)}")
    n = stats["frames"][0]["iterations"]
    va, vb = (read_obj(os.path.join(d, "Template", "template.obj"))["vertices"] for d in (a, b))
    pa, pb = (G.load_ply(os.path.join(d, "Template", "local_point_cloud.ply"), 0, device="cpu")[0]
              for d in (a, b))
    dv = float(np.abs(va - vb).max())
    dx = float(np.abs(pa.xyz - pb.xyz).max())
    logs = [[json.loads(x) for x in open(os.path.join(d, "seq", "logs", "frame_00000.jsonl"))
             if '"img"' in x] for d in (a, b)]
    print(f"dp s2 driver against one process: {len(files(a))} artifacts each, max |diff| "
          f"vertices {dv:.3g}, splat xyz {dx:.3g} ({n} iterations); img loss "
          + ", ".join(f"{x['img']:.6g}/{y['img']:.6g}" for x, y in zip(*logs)))
    check(len(logs[0]) == len(logs[1]) > 0, "dp s2 driver logs")
    for i, (x, y) in enumerate(zip(*logs)):
        check(abs(x["img"] - y["img"]) <= (1e-4 if i == 0 else 1e-2) * abs(x["img"]),
              f"dp s2 driver img loss {x['img']} vs {y['img']}")
    # the CPU test's atol on the meshes (tests/test_torch_data_parallel.py)
    check(dv <= 1e-5 and dx <= 1e-5, "dp s2 driver: vertices or xyz differ by more than 1e-5")

    # s3: epoch 5 from a fresh state saved at epoch 4, as one process and
    # under torchrun (on a trained state the splats' gradients sit at the
    # backward's noise floor, and Adam turns noise into full steps)
    for subject in ("subj_s3a", "subj_s3b"):
        dst = copy_stage2(out_root, subject)
        save_s3_ckpt(os.path.join(dst, "stage3"), epoch=4, active_sh_degree=SH_DEGREE, **fresh)
    stats = s3_appearance.main(s3_argv("subj_s3a", *S3_DP_FLAGS))
    out = torchrun("gaussian_garments_tpu_torch.s3_appearance",
                   s3_argv("subj_s3b", *S3_DP_FLAGS, "--data_parallel"),
                   "dp s3 driver under torch.distributed.run", backend)
    check("Resumed from epoch 4" in out and "pickle layout" in out, "dp s3 driver: resume line")
    a, b = (os.path.join(out_root, s, "stage3") for s in ("subj_s3a", "subj_s3b"))
    ca, cb = load_s3_ckpt(a), load_s3_ckpt(b)
    n = stats["steps"]["full"]["n"]
    # a resume restores the net and the splats, not the step count or the moments
    check(ca["epoch"] == cb["epoch"] == 5 and n == -(-stats["n_items"] // 2)
          and ca["iteration"] == cb["iteration"] == n, "dp s3 driver checkpoints")
    lrs = {"net": 5e-4, **splat_lrs(graft_entry.default_opt())}
    groups = lambda ck: {"net": np.concatenate([v.ravel() for v in _flat(ck["net_params"])
                                                .values()]),
                         **{k: np.asarray(getattr(ck["splats"], k)).ravel() for k in lrs
                            if k != "net"}}
    ga, gb, g0 = groups(ca), groups(cb), groups(fresh)
    q = lambda x: tuple(float(np.quantile(x, f)) if x.size else 0.0 for f in (0.5, 0.99))
    parts, moves = {}, {}
    for k in lrs:
        # the entries that either run moved (a texel no camera sees moves in neither)
        live = (ga[k] != g0[k]) | (gb[k] != g0[k])
        parts[k], moves[k] = q(np.abs(ga[k] - gb[k])[live]), q(np.abs(ga[k] - g0[k])[live])
    logs = [[json.loads(x) for x in open(os.path.join(d_, "logs", "train.jsonl"))
             if '"img"' in x] for d_ in (a, b)]
    print(f"dp s3 driver against one process, {n} steps each from a fresh state, over the "
          "entries either run moved: |diff| median, 99% within; moved from the start, median, "
          "99% within: " + ", ".join(
              f"{k} {parts[k][0]:.3g}, {parts[k][1]:.3g}; {moves[k][0]:.3g}, {moves[k][1]:.3g}"
              for k in lrs)
          + "; img loss " + ", ".join(f"{x['img']:.6g}/{y['img']:.6g}" for x, y in zip(*logs)))
    check(len(logs[0]) == len(logs[1]) > 0, "dp s3 driver logs")
    for i, (x, y) in enumerate(zip(*logs)):
        check(abs(x["img"] - y["img"]) <= (1e-4 if i == 0 else 1e-2) * abs(x["img"]),
              f"dp s3 driver img loss {x['img']} vs {y['img']}")
    # Two right runs part where the backward's atomics and cuDNN's order flip
    # the sign of a near-zero gradient, which Adam (eps 1e-15) turns into a
    # full step, and the flips compound over n steps: on an H100 the splats'
    # xyz and rotations, whose gradients are small and of unsteady sign, part
    # by up to a third of what they moved at the median, the net by 2%.
    # A wrong state, reduction or batch parts by about what the entries moved:
    # the net's median within 0.2, the splats' within 0.5 of the movement
    for k in lrs:
        bound = DRIVER_MEDIAN_PART["net" if k == "net" else "splats"]
        check(parts[k][0] <= bound * moves[k][0],
              f"dp s3 driver: {k} differs by {parts[k][0]:.3g} at the median, moved "
              f"{moves[k][0]:.3g}")


def drive_kernel_checks(torch, dev, root):
    """Both compositor kernels against their plain versions at the production
    drive's own shapes, from its artifacts under ``root``: the trained
    Template on frame 0's first 1024² camera (the s2 legs' frames, where the
    sheet covers under 1% of the frame and most tiles are empty), and the
    first s3 training item through the resumed checkpoint (texture 512, SH 3).
    Returns {kernel: max error}."""
    from gaussian_garments_tpu_torch import s3_appearance
    from gaussian_garments_tpu_torch.renderer import BatchedCameras

    with data_roots(os.path.join(root, "data"), os.path.join(root, "out")):
        _, state, cams = s2_template_state(torch, dev, os.path.join(root, "out"), "seq1")
        batch = BatchedCameras.from_cameras(cams[:1])
        w, h = batch.width, batch.height
        errs, *_ = hold_kernels(torch, dev, s2_project(torch, state, batch, 0), h, w, 7,
                                f"prod drive s2 shape, camera {cams[0].image_name} @ {w}x{h}")
        _, run = s3_appearance.prepare(["-s", "subj", "--texture_size", str(TEXTURE),
                                        "--sh_degree", str(SH_DEGREE), "--ckpt_backend", "orbax",
                                        "--device", "cuda"])
        check(run.start_epoch == 6, "the prod drive's s3 checkpoint did not resume")
        item = run.make_item([run.dataset[0]])
        proj, vis = s3_project(torch, run, item, SH_DEGREE)
        s3_errs, *_ = hold_kernels(
            torch, dev, proj, item.height, item.width, 8,
            f"prod drive s3 shape, camera {run.dataset[0]['camera'].image_name} @ "
            f"{item.width}x{item.height}, {run.n_texels} texel splats, {int(vis.sum())} visible")
    return {name: max(errs[name], s3_errs[name]) for name in errs}


def phase_prod_drive(torch, tmp):
    """The port's production drive (``python -m gaussian_garments_tpu_torch.prod_drive``)
    at full width and a cut depth, each leg a child process: the artifacts,
    the event kill and the resume, finite quality in every leg with bf16 within
    ``PD_BF16_DB`` of float32, the kernels' launches in each leg and no JAX
    module in any child; then both kernels against their plain versions at
    the drive's s2 and s3 shapes (``drive_kernel_checks``). Returns
    ({kernel: {leg: launches}}, {kernel: max error}, seconds)."""
    import numpy as np

    t0 = time.perf_counter()
    root = os.path.join(tmp, "prod_drive")
    print(f"prod drive cuts: {PD_CUTS}; full width: 12 cameras at 1024x1024, nx 48, texture "
          f"512, SH 3, inference at 940x1280")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    res = subprocess.run([sys.executable, "-m", "gaussian_garments_tpu_torch.prod_drive",
                          "--root", root, "--call", "chip_smoke", *PD_ARGS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=PD_TIMEOUT)
    check(res.returncode == 0, f"prod drive: exit {res.returncode}\n{res.stdout[-3000:]}\n"
          f"{res.stderr[-4000:]}")
    with open(os.path.join(root, "prod_drive_summary.json")) as f:
        summary = json.load(f)
    legs = summary["legs"]
    check(set(legs) == {"dataset", "s2_template", "s2_sequence", "s3_first", "s3_resume",
                        "eval_f32", "eval_bf16", "inference"}, f"prod drive legs {sorted(legs)}")
    for name, leg in legs.items():
        print(f"prod drive {name}: {leg['wall_s']} s" + "".join(
            f", {k} {v}" for k, v in leg.get("launches", {}).items()))
        check(leg.get("foreign_modules", []) == [], f"prod drive {name} imported "
              f"{leg.get('foreign_modules')}")
    check(summary["foreign_modules"] == [], "the prod drive imported JAX")

    out = os.path.join(root, "out", "subj")
    expect = [os.path.join("stage1", "template_uv.obj"),
              os.path.join("stage2", "Template", "template.obj"),
              os.path.join("stage3", "ckpt", "net.pkl"), os.path.join("stage3", "ckpt", "optm.pkl"),
              os.path.join("stage3", "logs", "train.jsonl")]
    expect += [os.path.join("stage2", "seq1", "meshes", f"frame_{t:05d}.obj") for t in range(2)]
    missing = [f for f in expect if not os.path.exists(os.path.join(out, f))]
    check(not missing, f"missing prod drive artifacts: {missing}")
    renders = sorted(os.listdir(os.path.join(root, "render_out", "renders")))
    check(renders == ["00000.png", "00001.png"] and summary["inference_frames"] == 2,
          f"prod drive renders {renders}")

    k = summary["s3_resumed_from"]
    check(summary["s3_interrupted"] and 1 <= summary["s3_kill_epoch"] <= 4,
          f"prod drive kill: {summary.get('s3_interrupted')}, epoch "
          f"{summary.get('s3_kill_epoch')}")
    check(k is not None and 1 <= int(k.split()[-1]) <= 4, f"prod drive resume: {k!r}")
    check(summary["s3_final_info"] == "Epoch 5", f"prod drive ended at {summary['s3_final_info']}")
    print(f"prod drive s3: killed at its first committed checkpoint (Epoch "
          f"{summary['s3_kill_epoch']}) after {summary['s3_first_leg_s']} s; '{k}'; ended at "
          f"'{summary['s3_final_info']}'")

    quality = [q[key] for q in summary["s2_frame_quality"].values()
               for key in ("test_psnr", "test_ssim")]
    quality += [summary["s3_eval"][key] for key in ("eval_psnr", "eval_ssim")]
    evals = summary["unet_bf16_delta"]
    quality += [evals[tag][key] for tag in ("f32", "bf16") for key in ("eval_psnr", "eval_ssim")]
    check(len(summary["s2_frame_quality"]) == 2 and all(np.isfinite(v) for v in quality),
          f"prod drive quality {quality}")
    gap = evals["bf16"]["eval_psnr"] - evals["f32"]["eval_psnr"]
    for name, q in summary["s2_frame_quality"].items():
        print(f"prod drive s2 {name}: test PSNR {q['test_psnr']} dB, SSIM {q['test_ssim']}")
    print(f"prod drive s3 eval at epoch {summary['s3_eval']['epoch']}: PSNR "
          f"{summary['s3_eval']['eval_psnr']:.4f} dB, SSIM {summary['s3_eval']['eval_ssim']:.4f}; "
          f"eval-only f32 {evals['f32']['eval_psnr']} dB, bf16 {evals['bf16']['eval_psnr']} dB "
          f"(bf16 - f32 {gap:+.4f} dB, limit {PD_BF16_DB})")
    check(abs(gap) <= PD_BF16_DB, f"prod drive bf16 eval {gap:+.4f} dB off float32")
    for mode, m in summary["s2_modes"].items():
        print(f"prod drive s2 {mode}: {m['iterations']} iterations, {m['s_per_iteration']:.4f} "
              f"s/iteration")
    for kind, m in summary["s3_steps"].items():
        print(f"prod drive s3 resume {kind}: {m['n']} steps, {m['s_per_step']:.4f} s/step")
    print("prod drive inference, s/frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in summary["inference_split"].items()))

    paths = {"dataset": ["dataset"], "s2": ["s2_template", "s2_sequence"], "s3": ["s3_resume"],
             "eval": ["eval_f32", "eval_bf16"], "inference": ["inference"]}
    launches = {kernel: {path: sum(legs[leg]["launches"][kernel] for leg in names)
                         for path, names in paths.items()}
                for kernel in ("composite_fwd", "composite_bwd")}
    errs = drive_kernel_checks(torch, torch.device("cuda", 0), root)
    secs = time.perf_counter() - t0
    print(f"prod drive phase: {secs:.1f} s")
    return launches, errs, secs


def _flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a.b": array}``."""
    import numpy as np

    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def phase_unused_modules(torch, dev):
    """The modules no driver runs, on the card against the CPU: the wavelet
    Discriminator at size 512 (6 channels, a batch of 4) and SMPL-X skinning
    at the model's shapes (seeded arrays: 10,475 vertices, 55 joints, a
    (486, 31,425) posedirs), each timed."""
    import copy

    import numpy as np
    from gaussian_garments_tpu_torch import lbs as L
    from gaussian_garments_tpu_torch.models.styleunet import Discriminator
    from gaussian_garments_tpu_torch.probes.common import cuda_ms

    net = Discriminator(512, img_channel=6, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn((4, 6, 512, 512), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(x)
        card = copy.deepcopy(net).to(dev)
        xd = x.to(dev)
        got = card(xd)
        ms = cuda_ms(lambda: card(xd), 5)
    err = float((got.cpu() - want).abs().max())
    print(f"Discriminator(512, 6) forward, batch 4: {ms:.3f} ms on the card (CUDA events, mean "
          f"of 5), max |card - CPU| {err:.3g} of outputs up to {float(want.abs().max()):.3g}")
    check(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4), "Discriminator card vs CPU")

    rng = np.random.RandomState(0)
    nv, nj = 10475, 55
    jr = np.zeros((nj, nv), np.float32)
    for j in range(nj):
        jr[j, rng.choice(nv, 20, replace=False)] = rng.dirichlet(np.ones(20))
    w = np.zeros((nv, nj), np.float32)
    w[np.arange(nv)[:, None], rng.randint(0, nj, size=(nv, 4))] = rng.dirichlet(np.ones(4), nv)
    parents = np.concatenate([[-1], [rng.randint(0, i) for i in range(1, nj)]])
    arrays = [(rng.randn(nv, 3) * 0.3).astype(np.float32),
              (rng.randn(nv, 3, 20) * 0.01).astype(np.float32),
              (rng.randn((nj - 1) * 9, nv * 3) * 0.01).astype(np.float32), jr, w]
    betas = (rng.randn(1, 20) * 0.5).astype(np.float32)
    pose = (rng.randn(1, nj * 3) * 0.3).astype(np.float32)

    def run(device):
        t = lambda a: torch.as_tensor(a, device=device)
        v_t, dirs, posedirs, jreg, weights = (t(a) for a in arrays)
        return lambda: L.lbs(t(betas), t(pose), v_t, dirs, posedirs, jreg, parents, weights)

    want = [x.numpy() for x in run("cpu")()]
    fn = run(dev)
    got = [x.cpu().numpy() for x in fn()]
    ms = cuda_ms(fn, 5)
    errs = [float(np.abs(g - w_).max()) for g, w_ in zip(got, want)]
    print(f"lbs at SMPL-X's shapes: {ms:.3f} ms on the card (CUDA events, mean of 5); max "
          f"|card - CPU| joint transforms {errs[0]:.3g}, vertices {errs[1]:.3g}, pose offsets "
          f"{errs[2]:.3g}")
    check(errs[0] <= 1e-5 and errs[1] <= 2e-5 and errs[2] <= 1e-5, "lbs card vs CPU")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    tmp = tempfile.mkdtemp(prefix="gg_chip_smoke_")
    out_root = os.path.join(tmp, "output")
    data_root = os.path.join(tmp, "data")
    # read when the config module loads
    os.environ.update(GG_OUTPUT_ROOT=out_root, GG_DATA_ROOT=data_root,
                      GG_AUX_ROOT=os.path.join(tmp, "aux"))
    sys.path.insert(0, REPO)
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.ops import cuda as kcuda

    pin_full_f32()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    builds = kcuda.build_kernels()
    for source, build in builds.items():
        kcuda.library(source)
        print(f"{source} built (nvcc {build['seconds']:.2f} s): {build['path']}")
        print(build["ptxas"])
    print(f"{len(builds)} kernel sources built and loaded in {time.perf_counter() - t0:.2f} s")

    try:
        errs = phase_kernel_checks(torch, dev)
        phase_bench_shape(torch, dev)
        probe_rows = phase_probes(torch)
        traj, render_dir, inference_argv, inf_err = phase_inference(torch, dev, tmp, out_root)
        t_new = time.perf_counter()
        inf_err = max(inf_err, phase_inference_modes(torch, dev, tmp, out_root, traj, render_dir,
                                                     inference_argv))
        added = time.perf_counter() - t_new
        s2_launches = phase_s2(torch, dev, data_root, out_root)
        s2_errs = phase_s2_split(torch, dev, out_root)[0]
        s3_run = phase_s3(torch, dev, out_root)
        s3_launches = s3_run[0]
        s3_errs, timing, split = phase_s3_split(torch, dev)
        t_new = time.perf_counter()
        bf16_launches, bf16_errs = phase_s3_bf16(torch, dev, out_root, s3_run, split)
        dense_launches, dense_errs = phase_s3_dense(torch, dev, out_root)
        added += time.perf_counter() - t_new
        t_new = time.perf_counter()
        dp_launches = phase_data_parallel(torch, dev, out_root)
        phase_unused_modules(torch, dev)
        dp_secs = time.perf_counter() - t_new
        s1_secs = phase_s1(torch, dev, data_root, out_root, card)[0]
        prod_launches, prod_errs, prod_secs = phase_prod_drive(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "gaussian_garments_tpu"))
    check(not bad, f"the port imported {bad}")

    relpath = lambda source: os.path.relpath(kcuda.source_path(source), REPO)
    kernels = []
    for name in ("composite_fwd", "composite_bwd"):
        source, replaces = kcuda.KERNELS[name]
        ms, plain_ms, bound_ms, bound_by = timing[name]
        check(s2_launches[name] > 0, f"{name} was not launched on the s2 path")
        check(s3_launches[name] > 0, f"{name} was not launched on the s3 path")
        check(bf16_launches[name] > 0, f"{name} was not launched on the s3 --unet_bf16 path")
        check(dense_launches[name] > 0, f"{name} was not launched on the s3 --dense_texels path")
        check(dp_launches[name] > 0, f"{name} was not launched by the data-parallel ranks")
        prod_paths = ("dataset", "s2", "s3", "eval", "inference") if name == "composite_fwd" \
            else ("s2", "s3")
        for path in prod_paths:
            check(prod_launches[name][path] > 0,
                  f"{name} was not launched on the prod drive's {path} legs")
        max_err = max(errs[name], s2_errs[name], s3_errs[name], bf16_errs[name], dense_errs[name],
                      prod_errs[name], inf_err if name == "composite_fwd" else 0.0)
        kernels.append({"name": name, "route": "cuda", "source": relpath(source),
                        "replaces": replaces, "launches": s3_launches[name],
                        "max_abs_err": max_err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "floor_ms": None})
    for r in probe_rows:
        kernels.append({"name": r["name"], "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "floor_ms": r["floor_ms"]})
    registered = {r["name"].split("@")[0] for r in probe_rows} | {"composite_fwd", "composite_bwd"}
    check(registered == set(kcuda.KERNELS),
          f"kernels not driven: {set(kcuda.KERNELS) - registered}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, {added:.1f} s of it in the "
          f"phases of the bf16, dense and exact-visibility paths, {dp_secs:.1f} s in the "
          f"data-parallel and unused-module phases, {s1_secs:.1f} s in the stage-1 phase, "
          f"{prod_secs:.1f} s in the prod drive phase")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
