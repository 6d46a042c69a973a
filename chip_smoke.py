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
   and on frame 0's bundle the forward kernel against its plain version;
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
   timed as in phase 4;
9. the kernel summary line (``floor_ms``: the launch floor where the probe
   times one, else null), the card line and the result line.

Iteration counts of phases 7 and 8 are cuts of the production schedule.
Imports nothing of JAX. Every number it prints is measured in this run,
except ``bound_ms``, which it computes from this run's inputs. Launch counts
are zeroed just before each path is driven and read just after; the
compositor kernels' ``launches`` in the summary are those of the stage-3 run.
"""
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
PROBE_REPS = 20


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
    import numpy as np
    from PIL import Image
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.doll import Simulation, concat_bundle
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
    from gaussian_garments_tpu_torch.probes.common import cuda_ms
    from gaussian_garments_tpu_torch.renderer import project

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
    tiles.composite_tiles_cuda.launches = 0
    t0 = time.perf_counter()
    stats = inference.main(argv)
    wall = time.perf_counter() - t0
    launches = tiles.composite_tiles_cuda.launches
    pngs = sorted(os.listdir(os.path.join(render_dir, "renders")))
    check(len(pngs) == FRAMES, f"expected {FRAMES} PNGs, got {pngs}")
    for name in pngs:
        img = np.asarray(Image.open(os.path.join(render_dir, "renders", name)))
        check(img.shape == (HEIGHT, 3 * WIDTH, 3), f"{name}: shape {img.shape}")
        check(img.std() > 0, f"{name}: constant image")
    check(all(np.isfinite(c) and c > 0 for c in stats["coverage"]),
          f"garment coverage {stats['coverage']}")
    check(launches >= 3 * FRAMES, f"composite_fwd launched {launches} times")
    print(f"inference path: {FRAMES} frames in {wall:.2f} s wall, composite_fwd launches "
          f"{launches}, coverage {[round(c, 3) for c in stats['coverage']]}")
    for i, t in enumerate(stats["frames"]):
        print(f"  frame {i}: " + " ".join(f"{k}={v:.3f}" for k, v in t.items()))
    print("  per-frame mean (s): " + " ".join(f"{k}={v:.3f}" for k, v in stats["mean"].items()))

    args = inference.parse_args(argv)
    with torch.no_grad():
        simu = Simulation(traj, render_dir, sh_degree=SH_DEGREE, texture_size=TEXTURE, device=dev)
        camera = inference.load_camera(simu.garment_names[0], args, dev)
        updates, vis = simu.forward(0, camera)
        face, _ = rasterize_mesh(updates[0]["mesh_v"], updates[0]["mesh_f"],
                                 camera.world_view_transform, camera.full_proj_transform,
                                 image_width=WIDTH, image_height=HEIGHT)
        framed = float((face >= 0).float().mean())
        check(framed >= 1 / 3, f"the garment covers {framed} of the frame, not a third")
        proj = project(camera, concat_bundle(updates, vis, SH_DEGREE, override="shs"))
        pairs = tiles.bin_pairs(proj, image_width=WIDTH, image_height=HEIGHT)
        kw = dict(image_height=HEIGHT, image_width=WIDTH)
        k = tiles.composite_tiles_cuda(pairs, **kw)
        p = tiles.composite_tiles_plain(pairs, **kw)
        live = proj.radii > 0
        counts = pairs.ranges[1:] - pairs.ranges[:-1]
        compare_fwd(torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()),
                    f"inference frame 0 @ {WIDTH}x{HEIGHT} (garment covers {framed:.3f}): "
                    f"{proj.means2d.shape[0]} splats, {int(pairs.ranges[-1])} pairs, max "
                    f"{int(counts.max())} per tile")
        ms = cuda_ms(lambda: tiles.composite_tiles_cuda(pairs, **kw), 20)
        plain = cuda_ms(lambda: tiles.composite_tiles_plain(pairs, **kw), 1)
        wk = work(torch, proj, pairs, k, HEIGHT, WIDTH)
        bound, by, nbytes, terms = wk["composite_fwd"]
        print(f"  composite_fwd at the inference shape: kernel {ms:.4f} ms (CUDA events, mean "
              f"of 20), plain {plain:.2f} ms (mean of 1), bound {bound:.4f} ms by {by} "
              f"({nbytes} B, {terms} terms); pairs {wk['rect_pairs']} in the plain rect, "
              f"{wk['pairs']} after the row-span cull")


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
    from gaussian_garments_tpu_torch.ops import tiles

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
        tiles.composite_tiles_cuda.launches = 0
        tiles.composite_tiles_backward_cuda.launches = 0
        t0 = time.perf_counter()
        stats = s2_registration.main(common + extra)
        wall = time.perf_counter() - t0
        fwd, bwd = tiles.composite_tiles_cuda.launches, tiles.composite_tiles_backward_cuda.launches
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
    import pickle
    from pathlib import Path

    import numpy as np
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import FrameDataloader
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.renderer import BatchedCameras, _project
    from gaussian_garments_tpu_torch.s2_registration import parse_args
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils.io import read_obj
    from gaussian_garments_tpu_torch.utils.losses import ssim

    args, _, op = parse_args(["-s", "subj", "-q", "seq"])
    opt = op.extract(args)
    root = Path(out_root) / "subj"
    args.subject_out = root
    cams = FrameDataloader(args, device=dev).load_frame(0)[1:1 + S2_PER_STEP]
    batch = BatchedCameras.from_cameras(cams)
    tmpl = root / DEFAULTS.stage2 / "Template"
    params, aux = G.load_ply(str(tmpl / "local_point_cloud.ply"), 0, device=dev)
    with open(tmpl / "binding.pkl", "rb") as f:
        binding = pickle.load(f)
    tem = read_obj(root / DEFAULTS.stage1 / "template_uv.obj")
    mesh = MM.create(read_obj(tmpl / "template.obj")["vertices"], tem["faces"], device=dev)
    state = S2.init_state(params, aux, binding, mesh)
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
        bundle = S2.splat_bundle(state.params, state.binding, state.aux.alive, state.mesh.v,
                                 state.mesh.f)
        proj = _project(bundle, batch.world_view[0], batch.full_proj[0], batch.campos[0],
                        width=w, height=h, tanfovx=batch.tanfovx[0], tanfovy=batch.tanfovy[0],
                        scaling_modifier=1.0, vis_mask=None, screen_offset=None)
        pairs = tiles.bin_pairs(proj, image_width=w, image_height=h)
        k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
        p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
        live = proj.radii > 0
        what = f"s2 shape, camera {cams[0].image_name} @ {w}x{h}"
        errs = {"composite_fwd": compare_fwd(
            torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()), what)}
        cot = cotangents(torch, dev, h, w, 5)
        errs["composite_bwd"] = compare_bwd(torch, tiles, pairs, k, cot, h, w, 1e-4, what)
        timing = time_both(torch, tiles, proj, pairs, k, cot, h, w, what)
    return errs, timing


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


def phase_s3(torch, dev, out_root):
    """``s3_appearance.main`` on the stage-2 output root (see the module doc)."""
    import numpy as np
    from gaussian_garments_tpu_torch import s3_appearance
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.training.checkpoints import (
        avatar_net_state_from_jax, load_s3_ckpt, s3_state_from_jax)

    print(f"s3 cuts: {S3_CUTS}")
    tiles.composite_tiles_cuda.launches = 0
    tiles.composite_tiles_backward_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stats = s3_appearance.main(S3_ARGS)
    wall = time.perf_counter() - t0
    launches = {"composite_fwd": tiles.composite_tiles_cuda.launches,
                "composite_bwd": tiles.composite_tiles_backward_cuda.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    steps = stats["steps"]
    n_steps = steps["pre"]["n"] + steps["full"]["n"]
    print(f"s3 run: {stats['n_items']} training items, {stats['n_texels']} texel splats, "
          f"{n_steps} steps in {wall:.1f} s wall; launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items()))
    check(n_steps == S3_STEPS and steps["pre"]["n"] == S3_PRE, f"s3 steps {steps}")
    check(launches["composite_bwd"] >= n_steps and launches["composite_fwd"] >= n_steps,
          f"s3: kernels launched {launches} times for {n_steps} steps")

    stage3 = os.path.join(out_root, "subj", "stage3")
    expect = [os.path.join("ckpt", f) for f in ("net.pkl", "optm.pkl", "info.txt")]
    expect += [os.path.join("logs", "train.jsonl"), os.path.join("debug", "e01_i000000.png"),
               os.path.join("debug", "e05_i000020.png")]
    missing = [f for f in expect if not os.path.exists(os.path.join(stage3, f))]
    check(not missing, f"missing s3 artifacts: {missing}")
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
    check(all(bool(torch.isfinite(v).all()) for v in state.net_params.values()),
          "non-finite net weights in the checkpoint")
    print(f"s3 checkpoint loads through the port: epoch {ck['epoch']}, iteration "
          f"{ck['iteration']}, AvatarNet {n_params} parameters, "
          f"{state.splats.xyz.shape[0]} splats")

    losses = stats["losses"]
    check(all(np.isfinite(v) for e in losses for k, v in e.items()
              if k not in ("epoch", "it", "kind")), "non-finite s3 loss")
    per_epoch = [np.mean([e["img"] for e in losses if e["epoch"] == ep]) for ep in range(1, 6)]
    print("s3 img loss, mean per epoch: " + ", ".join(f"{v:.5f}" for v in per_epoch))
    check(per_epoch[-1] < per_epoch[0], "s3: the img loss did not fall")
    check(len(stats["eval"]) == 10, f"s3: {len(stats['eval'])} evals")
    for q in stats["eval"]:
        check(all(np.isfinite(v) for v in q.values()), f"s3 eval {q}")
    for q in (stats["eval"][0], stats["eval"][-1]):
        print(f"s3 eval at epoch {q['epoch']}, step {q['step']}: " + " ".join(
            f"{k}={v:.4f}" for k, v in q.items() if k.startswith("eval_")))
    for kind, m in steps.items():
        print(f"s3 {kind} steps: {m['n']}, {m['seconds'] / m['n']:.4f} s/step (host clock, each "
              f"step ends in a synchronize; item loading not included)")
    print(f"s3 peak device memory: {peak / 2**30:.3f} GiB (max_memory_allocated)")
    return launches


def phase_s3_split(torch, dev):
    """Device split of one stage-3 step at full width, from the trained
    checkpoint and the first training item, each piece on the host clock
    around synchronize (mean of 5); then both kernels at that shape against
    their plain versions, timed."""
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

    _, run = s3_appearance.prepare(S3_ARGS)
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
            net, (params, state.net_buffers), net_in, {"rows": rows}).square().mean(),
            list(params.values()), allow_unused=True))
        timed("visibility (256² depth test)", lambda: AG.get_visible_mask_depth(
            bind, mesh_v, mesh_f, item.world_view[0], item.full_proj[0], image_width=256,
            image_height=256, rows=rows))
        with torch.no_grad():
            bundle, vis, _ = S3._s3_project(net, (state.net_params, state.net_buffers),
                                            state.splats, bind, mesh_f, item, 0,
                                            sh_degree=SH_DEGREE)
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
    print(f"s3 device split of one step at {w}x{h}, {run.n_texels} texel splats, "
          f"{int(vis.sum())} visible, {int(pairs.ranges[-1])} pairs, ms (mean of {reps}, host "
          f"clock around synchronize):")
    for k, v in ms.items():
        print(f"  {k}: {v:.3f}")

    with torch.no_grad():
        k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
        p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
        live = proj.radii > 0
        what = f"s3 shape, camera {run.dataset[0]['camera'].image_name} @ {w}x{h}"
        errs = {"composite_fwd": compare_fwd(
            torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()), what)}
        cot = cotangents(torch, dev, h, w, 5)
        errs["composite_bwd"] = compare_bwd(torch, tiles, pairs, k, cot, h, w, 1e-4, what)
        timing = time_both(torch, tiles, proj, pairs, k, cot, h, w, what)
    return errs, timing


def main() -> int:
    import torch

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
        phase_inference(torch, dev, tmp, out_root)
        s2_launches = phase_s2(torch, dev, data_root, out_root)
        s2_errs, _ = phase_s2_split(torch, dev, out_root)
        s3_launches = phase_s3(torch, dev, out_root)
        s3_errs, timing = phase_s3_split(torch, dev)
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
        kernels.append({"name": name, "route": "cuda", "source": relpath(source),
                        "replaces": replaces, "launches": s3_launches[name],
                        "max_abs_err": max(errs[name], s2_errs[name], s3_errs[name]), "ms": ms,
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
