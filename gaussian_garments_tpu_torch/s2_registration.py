"""Stage 2, garment registration (mesh tracking): the driver.

Port of the repo's ``s2_registration.py`` with the same flags and on-disk
layout. Template mode (``-tf`` set) fits one frame in two phases,
``first_frame_iterations`` on the splats then ``ff_collision_iteration`` on
the vertices, and writes ``stage2/Template/{local_point_cloud.ply,
point_cloud.ply, binding.pkl, template.obj, template_render.png}``. Sequence
mode (``-t Template``) tracks every frame with warm starts and writes
``stage2/<seq>/{meshes/frame_%05d.obj, point_cloud/frame_%05d/,
renders/%05d.png}``. Both write ``cameras.json``, ``cfg_args``, ``input.ply``
and ``logs/frame_%05d.jsonl`` under ``stage2/<seq>``.

    python -m gaussian_garments_tpu_torch.s2_registration -s SUBJECT -q SEQ -tf 0 \\
        [--device cuda] [--cameras_per_step 4] ...

Each step renders ``--cameras_per_step`` cameras (``training/s2.py``).
``--device`` defaults to ``cuda`` and raises when no GPU is present; only
``--device cpu`` runs the compositor's plain torch version. TF32 is off for
the whole run. ``--use_icp`` is accepted and, as in the JAX driver, does
nothing; ``--data_parallel`` is not ported. The log also records the first
iteration, so each frame's log starts from its initial loss, and each
densification (clone/split/prune counts and the mean and largest averaged
screen-space gradient it compared with ``--densify_grad_threshold``).

``main`` returns a small stats dict: per-mode iterations and wall seconds
(each step ends in a device synchronize), the frames done and their quality.
"""
from __future__ import annotations

import json
import os
import pickle
import random
import sys
import time
from argparse import ArgumentParser, Namespace
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    from gaussian_garments_tpu_torch.config import (ModelParams, OptimizationParams,
                                                    PipelineParams)

    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("-s", "--subject", type=str, required=True, default="")
    parser.add_argument("-so", "--subject_out", type=str, default="")
    parser.add_argument("-t", "--template_seq", type=str, default="")
    parser.add_argument("-q", "--sequence", type=str, required=True, default="")
    parser.add_argument("-tf", "--template_frame", type=int, default=None)
    parser.add_argument("--first_frame_iterations", type=int, default=10000)
    parser.add_argument("--first_frame_iterations_cross", type=int, default=15000)
    parser.add_argument("--other_frame_iterations", type=int, default=5000)
    parser.add_argument("--collision_iteration", type=int, default=2000)
    parser.add_argument("--ff_collision_iteration", type=int, default=2000)
    parser.add_argument("--start_from", type=int, default=-1)
    parser.add_argument("--use_icp", action="store_true")
    parser.add_argument("--camera", default="PINHOLE", type=str)
    parser.add_argument("--cameras_per_step", type=int, default=4,
                        help="cameras rendered per step (the reference samples 1)")
    parser.add_argument("--early_stop_rel", type=float, default=5e-4,
                        help="sequence frames: end a phase when the windowed total loss "
                             "improves by less than this relative amount; 0 disables")
    parser.add_argument("--early_stop_window", type=int, default=200,
                        help="iterations per plateau-detection window")
    parser.add_argument("--debug_nan", action="store_true",
                        help="check the losses every iteration and stop at the first "
                             "non-finite one")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no GPU is present")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    return args, lp, op


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import FrameDataloader
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras, RasterConfig, render
    from gaussian_garments_tpu_torch.scene import CrossScene, Scene, store_cam
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils.general import get_expon_lr_func
    from gaussian_garments_tpu_torch.utils.io import fetch_ply, read_obj, store_ply, write_obj
    from gaussian_garments_tpu_torch.utils.logging import (MetricLogger, StepTimer, debug_panel,
                                                           shaded_mesh_image)
    from gaussian_garments_tpu_torch.utils.quality import evaluate_cameras

    args, _, op = parse_args(argv)
    device = resolve_device(args.device)
    pin_full_f32()

    args.sh_degree = 0      # the reference's hard override (s2_registration.py:158)
    if len(args.subject_out) == 0:
        args.subject_out = args.subject
    args.subject_out = Path(DEFAULTS.output_root) / args.subject_out
    args.is_template = args.template_frame is not None
    if not args.is_template:
        args.first_frame_iterations = args.first_frame_iterations_cross
    stage2_path = Path(args.subject_out) / DEFAULTS.stage2 / args.sequence
    os.makedirs(stage2_path, exist_ok=True)
    with open(stage2_path / "cfg_args", "w") as f:
        f.write(str(Namespace(**vars(args))))
    opt = op.extract(args)

    dataloader = FrameDataloader(args, device=device)

    # template mesh + colours from the stage-1 cloud (mesh_gaussian_model.py:48-72)
    tem = read_obj(Path(args.subject_out) / DEFAULTS.stage1 / "template_uv.obj")
    centers = tem["vertices"][tem["faces"]].mean(1)
    pc_path = Path(args.subject_out) / DEFAULTS.stage1 / "point_cloud.ply"
    if pc_path.exists():
        from scipy.spatial import cKDTree

        pc = fetch_ply(pc_path)
        colors = pc.colors[cKDTree(pc.points).query(centers)[1]]
    else:
        colors = np.full((len(centers), 3), 0.5, np.float32)
    store_ply(stage2_path / "input.ply", centers, colors * 255)

    # SMPL-X hand vertices, left out of the collision body (mesh_gaussian_model.py:76-78)
    hand_list = np.zeros(0, np.int64)
    hand_json = Path(DEFAULTS.aux_root) / "smplx" / "smplx_vert_segmentation.json"
    if hand_json.exists():
        with open(hand_json) as f:
            seg = json.load(f)
        hand_list = np.array([v for k, verts in seg.items() for v in verts if "hand" in k.lower()])

    scene = (Scene if args.is_template else CrossScene)(args, dataloader, hand_list)
    mesh = MM.create(tem["vertices"], tem["faces"], device=device)
    cfg = RasterConfig()
    bg_color = torch.tensor([1.0, 1, 1] if args.white_background else [0.0, 0, 0],
                            device=device)
    frames_iterator = [args.template_frame] if args.is_template else range(len(dataloader))
    rng = random.Random(0)
    densify_rng = np.random.RandomState(0)   # advances across densifications
    binding_counter = np.ones(len(tem["faces"]), np.int32)
    state = None
    steps = {}
    stats = {"modes": {}, "frames": []}

    for t in frames_iterator:
        if args.start_from > 0 and t < args.start_from:
            continue
        is_ff = (t == 0) or args.is_template
        collision_iteration = args.ff_collision_iteration if is_ff else args.collision_iteration
        iterations = (args.first_frame_iterations + collision_iteration) if is_ff \
            else args.other_frame_iterations
        train_cams, test_cams = scene.prepare_frame_cameras(t)

        if is_ff and args.is_template:
            params, aux, binding, binding_counter = MG.create_from_template(
                tem["vertices"], tem["faces"], colors, max_sh_degree=args.sh_degree,
                device=device)
            state = S2.init_state(params, aux, binding, mesh)
            store_cam(dataloader.cam_info, stage2_path)
            state = state.replace(mesh=scene.setup_body(state.mesh, t))
        else:
            # sequence mode reloads the Template splats every frame (cross_scene.py:67-70)
            tmpl_ply = Path(args.subject_out) / DEFAULTS.stage2 / "Template" / \
                "local_point_cloud.ply"
            params, aux = G.load_ply(str(tmpl_ply), args.sh_degree, device=device)
            with open(tmpl_ply.parent / "binding.pkl", "rb") as f:
                binding = np.asarray(pickle.load(f))
            state = S2.init_state(params, aux, binding, mesh if state is None else state.mesh)
            if not is_ff:
                state = state.replace(mesh=scene.warm_start(state.mesh, t))
                state = state.replace(mesh=scene.setup_body(state.mesh, t, bind_frame=t - 1))
            else:
                state = state.replace(mesh=scene.setup_body(state.mesh, t))

        spatial_lr_scale = scene.cameras_extent
        xyz_sched = get_expon_lr_func(lr_init=opt.position_lr_init * spatial_lr_scale,
                                      lr_final=opt.position_lr_final * spatial_lr_scale,
                                      lr_delay_mult=opt.position_lr_delay_mult,
                                      max_steps=opt.position_lr_max_steps)
        vert_lr = opt.position_lr_init * spatial_lr_scale

        metrics_log = MetricLogger(str(stage2_path / "logs" / f"frame_{t:05d}.jsonl"))
        timer = StepTimer()
        viewpoint_stack = []
        plateau_on = args.early_stop_rel > 0 and not is_ff
        check_every = 25
        hist, prev_avg = [], None
        it = 0
        while it < iterations:
            it += 1
            use_body = it > iterations - collision_iteration
            if args.is_template:
                mode = "template_p2" if (is_ff and use_body) else "template_p1"
            else:
                mode = "seq"
            picked = []
            while len(picked) < args.cameras_per_step:
                if not viewpoint_stack:
                    viewpoint_stack = list(train_cams)
                picked.append(viewpoint_stack.pop(rng.randint(0, len(viewpoint_stack) - 1)))
            batch = BatchedCameras.from_cameras(picked)
            bg = torch.as_tensor(np.random.rand(3).astype(np.float32), device=device) \
                if opt.random_background else bg_color
            key = (mode, use_body)
            if key not in steps:
                steps[key] = S2.make_s2_step(opt, mode=mode, use_body=use_body,
                                             active_sh_degree=0, raster_cfg=cfg)
            xyz_lr = float(xyz_sched(it)) if (args.is_template and is_ff) else \
                opt.position_lr_init * spatial_lr_scale

            t0 = time.perf_counter()
            with timer.phase("step"):
                state, loss_dict, metrics = steps[key](state, batch, bg, xyz_lr, vert_lr)
                _sync(device)
            m = stats["modes"].setdefault(mode, {"iterations": 0, "seconds": 0.0})
            m["iterations"] += 1
            m["seconds"] += time.perf_counter() - t0
            if args.debug_nan and not all(bool(torch.isfinite(v)) for v in loss_dict.values()):
                raise FloatingPointError(f"non-finite loss at frame {t} iteration {it}: "
                                         f"{ {k: float(v) for k, v in loss_dict.items()} }")

            # densify / prune / opacity reset (template phase 1 only)
            if args.is_template and is_ff and not use_body:
                if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                    size_threshold = 20 if it > opt.opacity_reset_interval else None
                    aux = state.aux
                    grads = (aux.xyz_gradient_accum / aux.denom.clamp(min=1e-12))[aux.alive]
                    state, binding_counter, dstats = S2.densify_and_prune_state(
                        state, opt, scene.cameras_extent, size_threshold, binding_counter,
                        rng=densify_rng)
                    metrics_log.log(it, {}, **dstats, grad_mean=float(grads.mean()),
                                    grad_max=float(grads.max()))
                if it % opt.opacity_reset_interval == 0 or \
                        (args.white_background and it == opt.densify_from_iter):
                    state = S2.reset_opacity_state(state)

            if it == 1 or it % 100 == 0 or it == iterations:
                metrics_log.log(it, {k: float(v) for k, v in loss_dict.items()},
                                n_splats=float(state.aux.alive.sum()),
                                radii_max=float(metrics["radii_max"]),
                                n_overflow=float(metrics["n_overflow"]),
                                step_s=timer.avg.get("step", 0.0))
            if it % 500 == 0 or it == iterations:
                print(f"[frame {t} iter {it}/{iterations}] "
                      + " ".join(f"{k}={float(v):.5f}" for k, v in loss_dict.items()))

            if plateau_on and it % check_every == 0:
                hist.append(sum(float(v) for v in loss_dict.values()))
                if len(hist) * check_every >= args.early_stop_window:
                    avg, hist = float(np.mean(hist)), []
                    flat = prev_avg is not None and \
                        (prev_avg - avg) < args.early_stop_rel * abs(prev_avg)
                    prev_avg = avg
                    if flat:
                        body_start = iterations - collision_iteration
                        if not use_body and it < body_start and collision_iteration > 0:
                            print(f"[frame {t}] plateau at iter {it}; skipping to the "
                                  f"collision phase ({body_start})")
                            it = body_start
                            prev_avg = None   # the loss scale changes with the body terms
                        else:
                            print(f"[frame {t}] plateau at iter {it}; early stop")
                            break

        # artifacts (reference saver, s2_registration.py:88-122)
        with torch.no_grad():
            frames = MG.compute_face_frames(state.mesh.v, state.mesh.f)
            mesh_v = state.mesh.v.cpu().numpy()
            scene.save(t, state.params, state.aux, state.binding.cpu().numpy(), frames,
                       template=args.is_template)
            if args.is_template:
                template_dir = Path(args.subject_out) / DEFAULTS.stage2 / "Template"
                os.makedirs(template_dir, exist_ok=True)
                write_obj(dict(tem, vertices=mesh_v), template_dir / "template.obj")
                panel_path = template_dir / "template_render.png"
            else:
                panel_path = stage2_path / "renders" / f"{t:05d}.png"
            scene.save_mesh(t, tem, mesh_v)

            bundle = S2.splat_bundle(state.params, state.binding, state.aux.alive,
                                     state.mesh.v, state.mesh.f)
            render_fn = lambda c: render(c, bundle, bg_color, config=cfg)["render"]
            cam0 = train_cams[0]
            body_vf = scene.body_for_frame(t)
            mesh_img = shaded_mesh_image(mesh_v, tem["faces"], cam0,
                                         body_v=body_vf[0] if body_vf else None,
                                         body_f=body_vf[1] if body_vf else None)
            debug_panel(cam0.original_image.cpu().numpy(), cam0.gt_alpha_mask.cpu().numpy(),
                        render_fn(cam0).cpu().numpy(), mesh_render=mesh_img,
                        path=str(panel_path))

            # quality on the llffhold split (and a train probe) at the save point
            q_train = evaluate_cameras(train_cams, render_fn, max_cams=4)
            q_test = evaluate_cameras(test_cams, render_fn, max_cams=8)
        quality = {**{f"train_{k}": v for k, v in q_train.items()},
                   **{f"test_{k}": v for k, v in q_test.items()}}
        metrics_log.log(iterations, quality, frame=t)
        print(f"[frame {t}] quality: " + " ".join(f"{k}={v:.3f}" for k, v in quality.items()))
        with torch.no_grad():
            xyz = MG.world_xyz(state.params, state.binding, frames).cpu().numpy()
            rot = MG.world_rotation(state.params, state.binding, frames).cpu().numpy()
        scene.post_each_frame(is_ff, xyz, rot, tem["vertices"], tem["faces"],
                              state.binding.cpu().numpy())
        metrics_log.close()
        stats["frames"].append({"frame": t, "iterations": it,
                                "n_splats": int(state.aux.alive.sum()), **quality})

    for m in stats["modes"].values():
        m["s_per_iteration"] = m["seconds"] / max(m["iterations"], 1)
    print("\nTraining complete.")
    return stats


if __name__ == "__main__":
    main()
