#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gaussian_garments_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):
1. card and versions (exits non-zero without CUDA);
2. build both compositor kernels from ``gaussian_garments_tpu_torch/csrc``,
   one nvcc per source, started together;
3. ``composite_fwd`` against its plain torch version on seeded 20K-splat
   scenes at 256² (one whose wide splats hit the 6-tile clip), and against
   the exact oracle where nothing is clipped; ``composite_bwd`` against its
   plain version on the same scenes and on one saturated tile, and against
   torch autograd through the oracle at opacity ≤ 0.35;
4. both kernels at ``bench.py``'s shape (150K splats, 1920×1080), timed;
5. the inference path at production width (texture 512, SH degree 3,
   940×1280, 3 frames) through ``gaussian_garments_tpu_torch.inference.main``,
   and on frame 0's bundle the forward kernel against its plain version;
6. the stage-2 slice at full width through
   ``gaussian_garments_tpu_torch.s2_registration.main``: a synthetic 64×64
   sheet (7,938 faces), 12 cameras at 940×1280, 2 frames, 4 cameras per step,
   a template run then a sequence run, with the artifacts, the losses, the
   densification and the kernels' launch counts checked; then the device split
   of one iteration and both kernels against their plain versions at that
   shape, timed;
7. the kernel summary line, the card line and the result line.

Iteration counts of phase 6 are cuts of the production schedule (printed
before the run). Imports nothing of JAX. Every number it prints is measured
in this run, except ``bound_ms``, which it computes from this run's inputs.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"composite_fwd": "gaussian_garments_tpu_torch/csrc/composite_fwd.cu",
           "composite_bwd": "gaussian_garments_tpu_torch/csrc/composite_bwd.cu"}
REPLACES = {"composite_fwd": "gaussian_garments_tpu/ops/pallas_tiles.py:666",
            "composite_bwd": "gaussian_garments_tpu/ops/pallas_tiles.py:830"}
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
# NVIDIA H100 SXM: HBM3 at 3.35 TB/s (data sheet); special-function units at
# 16 results per clock per SM (CUDA C++ programming guide, arithmetic
# instruction throughput, compute capability 9.0) × 132 SMs × 1.98 GHz boost.
HBM_BYTES_S = 3.35e12
SFU_OPS_S = 16 * 132 * 1.98e9


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(a, b):
    return float((a - b).abs().max())


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def project_arrays(torch, dev, cam, arrays, w, h):
    from gaussian_garments_tpu_torch.ops.projection import project_gaussians
    t = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    return project_gaussians(
        t["means"], cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=w, image_height=h, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t["scales"], rotations=t["rots"], shs=t["shs"],
        opacities=t["opacity"].reshape(-1), sh_degree=0)


def work(torch, pairs, out, h, w):
    """Bytes each kernel must move and the pixel-pair evaluations this run's
    data needs. Forward: a pixel evaluates its tile's pairs until it saturates
    (T < 1e-4 after its last contributing pair) or the range ends. Backward: a
    pixel walks from its last contributing pair back to its tile's start."""
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.rasterizer_ref import T_EPS
    import math
    starts = pairs.ranges[:-1].long()
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).long()
    tiled = lambda x, fill: tiles._tile_pixels(x, pairs.tiles_x, pairs.tiles_y, fill)
    last = tiled(out.last_pair.long(), -1)
    logt = tiled(out.final_logt, 0.0)
    inside = tiled(torch.ones_like(out.final_logt), 0.0) > 0
    walked = torch.where(last >= 0, last - starts[:, None] + 1, torch.zeros_like(last))
    saturated = logt < math.log(T_EPS)
    fwd_evals = torch.where(saturated, walked, counts[:, None].expand_as(walked))
    fwd_evals = int(torch.where(inside, fwd_evals, torch.zeros_like(fwd_evals)).sum())
    bwd_evals = int(walked.sum())
    n, p, t = pairs.feats.shape[0], int(pairs.ranges[-1]), pairs.ranges.numel()
    hw = h * w
    fwd_bytes = n * 48 + p * 4 + t * 4 + hw * 4 * 7
    bwd_bytes = n * 48 + p * 4 + t * 4 + hw * 4 * 7 + n * 48
    bound = lambda b, e: max(b / HBM_BYTES_S, e / SFU_OPS_S) * 1e3
    by = lambda b, e: "bytes" if b / HBM_BYTES_S >= e / SFU_OPS_S else "operations"
    return {"composite_fwd": (bound(fwd_bytes, fwd_evals), by(fwd_bytes, fwd_evals),
                              fwd_bytes, fwd_evals),
            "composite_bwd": (bound(bwd_bytes, bwd_evals), by(bwd_bytes, bwd_evals),
                              bwd_bytes, bwd_evals)}


def time_both(torch, tiles, pairs, out, cot, h, w, what):
    kw = dict(image_height=h, image_width=w)
    args = (pairs, out.final_logt, out.last_pair, *cot)
    res = {
        "composite_fwd": (cuda_ms(torch, lambda: tiles.composite_tiles_cuda(pairs, **kw), 20),
                          cuda_ms(torch, lambda: tiles.composite_tiles_plain(pairs, **kw), 1)),
        "composite_bwd": (
            cuda_ms(torch, lambda: tiles.composite_tiles_backward_cuda(*args, **kw), 20),
            cuda_ms(torch, lambda: tiles.composite_tiles_backward_plain(*args, **kw), 1)),
    }
    bounds = work(torch, pairs, out, h, w)
    counts = pairs.ranges[1:] - pairs.ranges[:-1]
    print(f"{what}: {pairs.feats.shape[0]} splats, {int(pairs.ranges[-1])} pairs, deepest tile "
          f"{int(counts.max())} pairs, {counts.numel()} tiles")
    for name, (ms, plain) in res.items():
        b, by, nbytes, evals = bounds[name]
        print(f"  {name}: kernel {ms:.4f} ms (CUDA events, mean of 20), plain {plain:.2f} ms "
              f"(mean of 1), bound {b:.4f} ms by {by} ({nbytes} B, {evals} pixel-pair "
              f"evaluations)")
    return {name: (ms, plain, bounds[name][0], bounds[name][1])
            for name, (ms, plain) in res.items()}


def phase_kernel_checks(torch, dev):
    import numpy as np
    from gaussian_garments_tpu_torch.data.synthetic import make_splat_scene
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
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
        proj = project_arrays(torch, dev, cam, make_splat_scene(
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
    proj = project_arrays(torch, dev, cam64, arrays, small, small)
    pairs = tiles.bin_pairs(proj, image_width=small, image_height=small)
    out = tiles.composite_tiles_cuda(pairs, image_height=small, image_width=small)
    counts = pairs.ranges[1:] - pairs.ranges[:-1]
    check(int(counts.max()) > 256 and float(out.alpha.max()) > 0.9999, "tile not saturated")
    errs["composite_bwd"] = max(errs["composite_bwd"], compare_bwd(
        torch, tiles, pairs, out, cotangents(torch, dev, small, small, 7), small, small, 2e-4,
        f"saturated tile: 600 splats of opacity 0.97 @ {small}², deepest tile "
        f"{int(counts.max())} pairs"))

    # the backward kernel through autograd against autograd of the exact oracle
    proj = project_arrays(torch, dev, cam, make_splat_scene(3000, 3, max_opacity=0.35),
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
    import numpy as np
    from gaussian_garments_tpu_torch.data.synthetic import build_garment_splats
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.utils.camera import make_camera

    w, h = 1920, 1080
    means, scales, rots, opac, shs = build_garment_splats(150_000, np.random.RandomState(0))
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.2]), fx=2200.0, fy=2200.0, cx=w / 2,
                      cy=h / 2, width=w, height=h, device=dev)
    proj = project_arrays(torch, dev, cam, {"means": means, "scales": scales, "rots": rots,
                                            "opacity": opac, "shs": shs}, w, h)
    with torch.no_grad():
        pairs = tiles.bin_pairs(proj, image_width=w, image_height=h)
        k = tiles.composite_tiles_cuda(pairs, image_height=h, image_width=w)
        p = tiles.composite_tiles_plain(pairs, image_height=h, image_width=w)
        live = proj.radii > 0
        compare_fwd(torch, k, p, float(proj.depth[live].max() - proj.depth[live].min()),
                    f"bench.py shape, 150000 splats @ {w}x{h}")
        cot = cotangents(torch, dev, h, w, 11)
        compare_bwd(torch, tiles, pairs, k, cot, h, w, 1e-4, f"bench.py shape @ {w}x{h}")
        time_both(torch, tiles, pairs, k, cot, h, w, f"bench.py shape @ {w}x{h}")


def phase_inference(torch, dev, tmp, out_root):
    import numpy as np
    from PIL import Image
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.doll import Simulation, concat_bundle
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
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
        ms = cuda_ms(torch, lambda: tiles.composite_tiles_cuda(pairs, **kw), 20)
        plain = cuda_ms(torch, lambda: tiles.composite_tiles_plain(pairs, **kw), 1)
        bound, by, nbytes, evals = work(torch, pairs, k, HEIGHT, WIDTH)["composite_fwd"]
        print(f"  composite_fwd at the inference shape: kernel {ms:.4f} ms (CUDA events, mean "
              f"of 20), plain {plain:.2f} ms (mean of 1), bound {bound:.4f} ms by {by} "
              f"({nbytes} B, {evals} pixel-pair evaluations)")


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
        timing = time_both(torch, tiles, pairs, k, cot, h, w, what)
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
    from gaussian_garments_tpu_torch.ops import tiles

    pin_full_f32()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    builds = tiles.build_kernels()
    for name, build in builds.items():
        tiles._library(name)
        print(f"{name} built (nvcc {build['seconds']:.2f} s): {build['path']}")
        print(build["ptxas"])
    print(f"both kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    try:
        errs = phase_kernel_checks(torch, dev)
        phase_bench_shape(torch, dev)
        phase_inference(torch, dev, tmp, out_root)
        launches = phase_s2(torch, dev, data_root, out_root)
        s2_errs, timing = phase_s2_split(torch, dev, out_root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "gaussian_garments_tpu"))
    check(not bad, f"the port imported {bad}")

    kernels = []
    for name in SOURCES:
        ms, plain_ms, bound_ms, bound_by = timing[name]
        check(launches[name] > 0, f"{name} was not launched on the s2 path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": max(errs[name], s2_errs[name]), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
