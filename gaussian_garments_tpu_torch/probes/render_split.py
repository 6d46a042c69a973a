"""Host-clock split of the differentiable render of one step on the card:
projection, binning, the forward kernel and the backward kernel, each
between two ``torch.cuda.synchronize()`` calls, summed over the step's
cameras, mean of ``--reps``; and the ATen ops that one binning call
dispatches (each a launch or a host-side op; views apart).

    python -m gaussian_garments_tpu_torch.probes.render_split [--scene s3|s2] [--reps 20]

Scenes, at 940×1280:

- ``s3``: the texel scene that inference and stage 3 render, one camera:
  frame 0 of ``write_inference_inputs``' seeded garment (texture 512:
  262,144 texel splats, SH degree 3, seeded random AvatarNet weights),
  projected as ``chip_smoke.py``'s inference phase projects it;
- ``s2``: a stage-2 iteration's 4 cameras: ``write_reference_layout``'s
  64×64 sheet and cameras as ``chip_smoke.py``'s stage-2 phase builds them,
  and the Template splats as ``s2_registration`` creates them at its first
  iteration (one per face, 7,938).

The probe uses only entry points that earlier versions of the port share,
so the same file can time two checkouts of the port, in turns, within one
call on one card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

WIDTH, HEIGHT, TEXTURE, SH_DEGREE = 940, 1280, 512, 3
S2_CAMERAS = 4


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", choices=("s3", "s2"), default="s3", help="the step to render")
    p.add_argument("--reps", type=int, default=20, help="timed renders")
    return p.parse_args(sys.argv[1:] if argv is None else list(argv))


def s3_views(dev, tmp):
    """One projection callable: the texel scene's camera."""
    import torch
    from gaussian_garments_tpu_torch import inference
    from gaussian_garments_tpu_torch.data.synthetic import write_inference_inputs
    from gaussian_garments_tpu_torch.doll import Simulation, concat_bundle
    from gaussian_garments_tpu_torch.renderer import project

    traj = os.path.join(tmp, "traj.pkl")
    write_inference_inputs(os.environ["GG_OUTPUT_ROOT"], traj, nx=48, ny=48,
                           texture_size=TEXTURE, sh_degree=SH_DEGREE, width=WIDTH,
                           height=HEIGHT, n_frames=1)
    argv_inf = ["--traj_path", traj, "--output_path", os.path.join(tmp, "render"), "--device",
                "cuda", "--texture_size", str(TEXTURE), "--sh_degree", str(SH_DEGREE),
                "--width", str(WIDTH), "--height", str(HEIGHT)]
    with torch.no_grad():
        simu = Simulation(traj, os.path.join(tmp, "render"), sh_degree=SH_DEGREE,
                          texture_size=TEXTURE, device=dev)
        camera = inference.load_camera(simu.garment_names[0], inference.parse_args(argv_inf),
                                       dev)
        updates, vis = simu.forward(0, camera)
        bundle = concat_bundle(updates, vis, SH_DEGREE, override="shs")
    return [lambda: project(camera, bundle)], f"{bundle.means3d.shape[0]} texel splats, 1 camera"


def s2_views(dev, tmp):
    """Four projection callables: the stage-2 Template at its first iteration,
    seen by 4 of frame 0's cameras."""
    from pathlib import Path

    import numpy as np
    import torch
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import FrameDataloader
    from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras, _project
    from gaussian_garments_tpu_torch.s2_registration import parse_args as s2_args
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.utils.io import read_obj

    write_reference_layout(os.environ["GG_DATA_ROOT"], os.environ["GG_OUTPUT_ROOT"], "subj",
                           "seq", n_cams=12, n_frames=1, nx=64, ny=64, width=WIDTH,
                           height=HEIGHT, ring_radius=0.5, ring_height=2.0, cover=1.1,
                           device=dev)
    args, _, _ = s2_args(["-s", "subj", "-q", "seq"])
    args.subject_out = Path(DEFAULTS.output_root) / "subj"
    batch = BatchedCameras.from_cameras(
        FrameDataloader(args, device=dev).load_frame(0)[1:1 + S2_CAMERAS])
    tem = read_obj(args.subject_out / DEFAULTS.stage1 / "template_uv.obj")
    colors = np.full((len(tem["faces"]), 3), 0.5, np.float32)
    params, aux, binding, _ = MG.create_from_template(tem["vertices"], tem["faces"], colors,
                                                      max_sh_degree=0, device=dev)
    state = S2.init_state(params, aux, binding,
                          MM.create(tem["vertices"], tem["faces"], device=dev))
    with torch.no_grad():
        bundle = S2.splat_bundle(state.params, state.binding, state.aux.alive, state.mesh.v,
                                 state.mesh.f)

    def view(b):
        return lambda: _project(bundle, batch.world_view[b], batch.full_proj[b],
                                batch.campos[b], width=WIDTH, height=HEIGHT,
                                tanfovx=batch.tanfovx[b], tanfovy=batch.tanfovy[b],
                                scaling_modifier=1.0, vis_mask=None, screen_offset=None)

    n = int(state.aux.alive.sum())
    return [view(b) for b in range(S2_CAMERAS)], f"{n} splats, {S2_CAMERAS} cameras"


def count_ops(fn):
    """(ops, views): the ATen ops that ``fn()`` dispatches, views apart."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.is_view:
                self.views += 1
            else:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.ops, c.views


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import numpy as np
    import torch

    args = parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="gg_render_split_")
    # read when the config module loads
    os.environ.update(GG_OUTPUT_ROOT=os.path.join(tmp, "output"),
                      GG_DATA_ROOT=os.path.join(tmp, "data"), GG_AUX_ROOT=os.path.join(tmp, "aux"))
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.ops import tiles

    if not torch.cuda.is_available():
        raise RuntimeError("render_split times the card: no CUDA device")
    pin_full_f32()
    dev = torch.device("cuda", 0)
    views, what = (s3_views if args.scene == "s3" else s2_views)(dev, tmp)
    g = torch.as_tensor(np.random.RandomState(0).randn(5, HEIGHT, WIDTH).astype(np.float32),
                        device=dev)
    cot = (g[:3].contiguous(), g[3:4].contiguous(), g[4:5].contiguous())
    kw = dict(image_height=HEIGHT, image_width=WIDTH)
    steps = {
        "projection": lambda view: view(),
        "binning": lambda proj: tiles.bin_pairs(proj, image_width=WIDTH, image_height=HEIGHT),
        "composite_fwd kernel": lambda pairs: (pairs, tiles.composite_tiles_cuda(pairs, **kw)),
        "composite_bwd kernel": lambda po: tiles.composite_tiles_backward_cuda(
            po[0], po[1].final_logt, po[1].last_pair, *cot, **kw),
    }
    ms = {name: 0.0 for name in steps}
    with torch.no_grad():
        for rep in range(args.reps + 1):       # the first pass warms up
            for view in views:
                x = view
                for name, fn in steps.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    x = fn(x)
                    torch.cuda.synchronize()
                    if rep:
                        ms[name] += (time.perf_counter() - t0) * 1e3 / args.reps
        proj = views[0]()
        n_ops, n_views = count_ops(lambda: steps["binning"](proj))
    shutil.rmtree(tmp, ignore_errors=True)
    import gaussian_garments_tpu_torch as pkg

    print(f"render split of one {args.scene} step @ {WIDTH}x{HEIGHT}, {what} "
          f"({os.path.dirname(pkg.__file__)}), ms summed over the cameras, host clock around "
          f"synchronize, mean of {args.reps}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f", all {sum(ms.values()):.3f}; binning dispatches {n_ops} ops and {n_views} views",
          flush=True)
    return ms


if __name__ == "__main__":
    main()
