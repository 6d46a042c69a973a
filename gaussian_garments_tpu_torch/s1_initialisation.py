"""Stage 1, geometry initialisation: the driver.

Port of the repo's ``s1_initialisation.py`` with the same flags and on-disk
layout (reference ``s1_initialisation.py:7-35``): export the template frame
for COLMAP, run the COLMAP MVS chain, and post-process the fused cloud into a
garment template mesh. The UV unwrap stays a manual Blender step.

    python -m gaussian_garments_tpu_torch.s1_initialisation -s SUBJECT -q SEQ \\
        [--skip_colmap] [--grid_res 256] [--remesh_faces 8000] [--device cuda]

Writes ``images/``, ``masks/<cam>.png.png``, ``sparse_known/``,
``cameras.json``, ``point_cloud.ply``, ``poisson.obj``, ``segmented.obj``,
``segmented_labels.npy``, ``parser.obj`` and ``template.obj`` under
``<output_root>/<subject_out>/stage1``. ``--device`` defaults to ``cuda`` and
raises when no GPU is present; only ``--device cpu`` runs on the CPU.
``--gpu`` and ``--visualize`` are accepted and, as in the JAX driver, do
nothing. ``main`` returns the artifacts' paths and the host-clock split of
the run (a device synchronize around each phase).
"""
from __future__ import annotations

import sys
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

from gaussian_garments_tpu_torch import resolve_device

ARTIFACTS = ("images", "masks", "sparse_known", "cameras.json", "point_cloud.ply",
             "poisson.obj", "segmented.obj", "segmented_labels.npy", "parser.obj",
             "template.obj")


def initialization_parser():
    parser = ArgumentParser(description="Initialisation script parameters")
    parser.add_argument("-s", "--subject", type=str, required=True)
    parser.add_argument("-so", "--subject_out", type=str, default="")
    parser.add_argument("-q", "--sequence", type=str, required=True)
    parser.add_argument("-tf", "--template_frame", type=int, default=0)
    parser.add_argument("--camera", default="PINHOLE", type=str)
    parser.add_argument("--gpu", action="store_true")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    # no reference analogue: skip the COLMAP chain when a fused.ply already
    # exists; the meshing resolution and face budget (the reference hardcodes
    # depth 13 / 8000 faces)
    parser.add_argument("--skip_colmap", action="store_true")
    parser.add_argument("--no_segmentation", action="store_true",
                        help="skip garment-mask segmentation (whole scan)")
    parser.add_argument("--grid_res", type=int, default=None)
    parser.add_argument("--remesh_faces", type=int, default=8000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no GPU is present")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.stages.s1 import (colmap_recon, load_segmentation_inputs,
                                                       post_process, prepare_dataset)
    from gaussian_garments_tpu_torch.utils.logging import PhaseSplit

    args = initialization_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(args.device)
    pin_full_f32()
    if len(args.subject_out) == 0:
        args.subject_out = args.subject

    source_root = Path(DEFAULTS.data_root) / args.subject / args.sequence
    target_root = Path(DEFAULTS.output_root) / args.subject_out / DEFAULTS.stage1

    split = PhaseSplit(device)
    t0 = time.perf_counter()
    with split.phase("export"):
        prepare_dataset(source_root, target_root, args.camera,
                        template_frame=args.template_frame, overwrite=args.overwrite,
                        device=device)
    if not args.skip_colmap:
        with split.phase("colmap"):
            colmap_recon(target_root, gpu=args.gpu)
    # the reference always segments the scan against the garment masks
    # (utils/initialisation_utils.py:152-156 → utils/parse_scan.py:53-119)
    with split.phase("load_masks"):
        cameras, masks = (None, None) if args.no_segmentation \
            else load_segmentation_inputs(target_root, device=device)
    if cameras is None and not args.no_segmentation:
        print("[stage1] WARNING: no masks/cameras found under the target "
              "root; emitting an UNSEGMENTED template")
    post_process(target_root, target_root, cameras=cameras, garment_masks=masks,
                 grid_res=args.grid_res, remesh_faces=args.remesh_faces, device=device,
                 split=split)
    seconds = time.perf_counter() - t0
    print("Stage 1 complete. UV-unwrap template.obj to template_uv.obj "
          "(manual Blender step, README.md:73).")
    artifacts = {name: target_root / name for name in ARTIFACTS
                 if (target_root / name).exists()}
    return {"target_root": target_root, "artifacts": artifacts, "split": split.times,
            "seconds": seconds}


if __name__ == "__main__":
    main()
