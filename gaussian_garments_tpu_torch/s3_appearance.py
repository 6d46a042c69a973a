"""Stage 3, appearance training: the command-line entry point.

Port of the repo's ``s3_appearance.py`` with the same flags and on-disk
layout: an epoch loop over every (sequence, frame, camera) item of a subject,
training AvatarNet and the texel splats (``training/s3.py``), checkpointing
to ``stage3/ckpt/{net.pkl,optm.pkl,info.txt}`` every ``--save_iterations``
items and at the end of each epoch, logging to ``stage3/logs/train.jsonl``
and writing the [AO | normal | |ΔRGB|] texture panels to
``stage3/debug/e??_i??????.png``. The reference's hard overrides are kept: 5
epochs, eval (llffhold) split, shuffle, random background, blurred mask,
numpy seed 31359. A checkpoint in ``--ckpt_path`` (or ``stage3``) resumes
the net and splats at the next epoch, as the JAX package's ``s3_appearance.py`` does.

    python -m gaussian_garments_tpu_torch.s3_appearance -s SUBJECT \\
        [--device cuda] [--texture_size 512] [--sh_degree 3] ...

``--device`` defaults to ``cuda`` and raises when no GPU is present; only
``--device cpu`` runs the compositor's plain torch version. TF32 is off for
the whole run. The per-item visibility is a constant of the item and is
cached across epochs, packbits'd. ``--unet_bf16`` runs the StyleUNet in bf16
over float32 master weights; ``--dense_texels`` trains the dense res² texel
layout, and a checkpoint of either layout resumes into either.

``--data_parallel`` under ``torchrun`` shards each step's items over the
ranks (``--items_per_step`` a multiple of the world size): every rank loads
the whole batch, so that the numpy stream of random backgrounds stays in step,
trains on its contiguous block, and averages the gradients and losses with the
others before Adam. Rank 0 alone writes the checkpoint, debug panels and logs
and renders the eval; every rank resumes from the checkpoint, and rank 0's
starting state is broadcast. Without a launcher the flag runs one process.

``--ckpt_backend orbax`` keeps the JAX flag's two properties over the pickle
layout, since reading or writing orbax needs jax: mid-epoch saves are
asynchronous (the write overlaps the next steps, and the run waits for it at
the end) and a save is committed whole: its files are written into a
temporary directory, which then takes the place of ``ckpt/`` in one step
(``training/checkpoints.py::_write_all``), so a run killed mid-save leaves the
previous checkpoint whole. An orbax checkpoint
is refused by name; ``scripts/orbax_to_pickle.py`` converts one where jax is.

``main`` returns a stats dict: per step kind (``pre``: net only; ``full``:
net and splats) the steps and wall seconds (each step ends in a device
synchronize), every step's losses, and the eval metrics of each save point.
"""
from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser, Namespace
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device

def parse_args(argv: Optional[Sequence[str]] = None):
    from gaussian_garments_tpu_torch.config import OptimizationParams, PipelineParams

    parser = ArgumentParser(description="Training script parameters")
    op = OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("-s", "--subject", type=str, required=True, default="")
    parser.add_argument("-so", "--subject_out", type=str, default="")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--texture_size", type=int, default=512)
    parser.add_argument("--texture_margin", type=int, default=5)
    parser.add_argument("--white_background", action="store_true", default=False)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--save_iterations", type=int, default=3000)
    parser.add_argument("--pre_train_iterations", type=int, default=3000)
    parser.add_argument("--lr_init", type=float, default=5e-4)
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--random_bg", action="store_true")
    parser.add_argument("--blur_mask", action="store_true")
    parser.add_argument("--llffhold", type=int, default=12)
    parser.add_argument("--items_per_step", type=int, default=1)
    parser.add_argument("--dense_texels", action="store_true",
                        help="dense res^2 texel layout with an alive mask: texture gathers and "
                             "scatters become reshapes")
    parser.add_argument("--unet_bf16", action="store_true",
                        help="bf16 UNet activations over float32 master weights")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the item batch over the ranks of a torchrun launch "
                             "(items_per_step must be a multiple of the world size)")
    parser.add_argument("--eval_only", action="store_true",
                        help="load the checkpoint, run the held-out PSNR/SSIM eval, print one "
                             "EVAL_ONLY json line and exit")
    parser.add_argument("--eval_items", type=int, default=4,
                        help="held-out items rendered for PSNR/SSIM at save points")
    parser.add_argument("--ckpt_backend", type=str, default="pickle", choices=("pickle", "orbax"),
                        help="orbax: asynchronous mid-epoch saves with atomic commits, "
                             "written in the pickle layout")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no GPU is present")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    return args, op


def _save_debug_textures(net, state, bind, mesh_f, item, stage3_path: Path, epoch: int,
                         it: int) -> None:
    """[AO | object-space normal | |ΔRGB| of the shadow net] texture panel
    (reference debug textures, s3_appearance.py:155-202)."""
    from torch.func import functional_call

    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.training.s3 import _cast_net_vars
    from gaussian_garments_tpu_torch.utils.io import save_image

    with torch.no_grad():
        frames = MG.compute_face_frames(item.mesh_v[0], mesh_f)
        out = functional_call(net, _cast_net_vars(net, (state.net_params, state.net_buffers)), (
            item.ambient[0], item.normal[0], item.world_view[0], item.campos[0], bind,
            item.mesh_v[0], mesh_f, frames))
        drgb = out[3:6].abs()
        drgb = drgb / torch.clamp(drgb.max(), min=1e-6)
        panel = torch.cat([item.ambient[0].expand(3, -1, -1), item.normal[0], drgb], dim=2)
    save_image(stage3_path / "debug" / f"e{epoch:02d}_i{it:06d}.png",
               panel.permute(1, 2, 0).cpu().numpy())


def prepare(argv: Optional[Sequence[str]] = None):
    """Parse the flags and build what a run trains: the UV binding, the
    dataset, the net, the state (resumed from a checkpoint when there is one)
    and ``make_item``, which turns dataset entries into an ``S3Item`` with
    the cached visibility. Returns (args, run namespace)."""
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.data.readers import AvatarDataset
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.training.checkpoints import (
        avatar_net_state_from_jax, has_s3_ckpt, load_s3_ckpt)
    from gaussian_garments_tpu_torch.utils.io import read_obj

    from gaussian_garments_tpu_torch import parallel

    args, op = parse_args(argv)
    device, group = parallel.driver_group(args.data_parallel, resolve_device(args.device),
                                          args.items_per_step, "--items_per_step")
    if args.ckpt_backend == "orbax" and parallel.is_main(group):
        print("[ckpt] --ckpt_backend orbax: the port writes the pickle layout (net.pkl, "
              "optm.pkl) with asynchronous mid-epoch saves and atomic commits")
    pin_full_f32()

    if len(args.subject_out) == 0:
        args.subject_out = args.subject
    args.subject_out = Path(DEFAULTS.output_root) / args.subject_out
    stage3_path = Path(args.subject_out) / DEFAULTS.stage3

    # the reference's hard overrides (s3_appearance.py:81-90)
    args.debug = False
    args.epochs = 5
    args.eval = True
    args.shuffle = True
    args.random_bg = True
    args.blur_mask = True
    np.random.seed(31359)

    opt = op.extract(args)
    run_args = Namespace(**{**vars(opt), "lr_init": args.lr_init})

    template = read_obj(Path(args.subject_out) / DEFAULTS.stage1 / "template_uv.obj")
    bind, _ = AG.build_binding(template["uvs"], template["texture_faces"], args.texture_size,
                               dense=args.dense_texels, device=device)
    dataset = AvatarDataset(args, bind=bind, device=device)
    mesh_f = torch.as_tensor(np.asarray(template["faces"], np.int64), device=device)

    # splats from the stage-2 Template (avatar_gaussian_model.py:69-138)
    tmpl_pc = Path(args.subject_out) / DEFAULTS.stage2 / "Template"
    splats, _ = AG.init_from_template(bind, template["vertices"], template["faces"],
                                      str(tmpl_pc / "point_cloud.ply"),
                                      str(tmpl_pc / "local_point_cloud.ply"), args.sh_degree,
                                      device=device)
    net = AvatarNet(texture_size=args.texture_size, sh_degree=args.sh_degree,
                    generator=torch.Generator().manual_seed(0),
                    act_dtype=torch.bfloat16 if args.unet_bf16 else torch.float32).to(device)
    state = S3.init_state(net, splats)

    # resume the net and the splats, as the JAX package's s3_appearance.py does
    start_epoch = 1
    ckpt_dir = args.ckpt_path or stage3_path
    if has_s3_ckpt(ckpt_dir):
        ck = load_s3_ckpt(ckpt_dir)
        weights = avatar_net_state_from_jax(ck["net_params"], ck["net_buffers"])
        state = state.replace(
            net_params={k: weights[k].to(device) for k in state.net_params},
            net_buffers={k: weights[k].to(device) for k in state.net_buffers},
            splats=AG.adapt_params_layout(bind, ck["splats"].to(device)))
        start_epoch = ck["epoch"] + 1
        if parallel.is_main(group):
            print(f"Resumed from epoch {ck['epoch']}")
    state = parallel.broadcast_from_rank0(state, group)   # equal on every rank

    # per-item visibility cache: a constant of the (seq, frame, camera) item,
    # stored packbits'd
    n_texels = bind.binding.shape[0]
    vis_cache = {}

    def item_vis(b) -> torch.Tensor:
        c = b["camera"]
        key = (b["current_seq"], b["current_frame"], c.image_name)
        if key not in vis_cache:
            with torch.no_grad():
                v = AG.get_visible_mask_depth(
                    bind, torch.as_tensor(b["mesh_v"], device=device), mesh_f,
                    c.world_view_transform, c.full_proj_transform, image_width=256,
                    image_height=256)
            vis_cache[key] = np.packbits(v.cpu().numpy())
        return torch.as_tensor(np.unpackbits(vis_cache[key], count=n_texels).astype(np.float32),
                               device=device)

    def make_item(batch) -> S3.S3Item:
        cams = [b["camera"] for b in batch]
        t = lambda key: torch.stack([torch.as_tensor(b[key], device=device) for b in batch])
        return S3.S3Item(
            image=torch.stack([c.original_image for c in cams]),
            mask=torch.stack([c.gt_alpha_mask for c in cams]),
            bg=t("bg"), mesh_v=t("mesh_v"), ambient=t("ambient"), normal=t("normal"),
            world_view=torch.stack([c.world_view_transform for c in cams]),
            full_proj=torch.stack([c.full_proj_transform for c in cams]),
            campos=torch.stack([c.camera_center for c in cams]),
            tanfovx=tuple(c.tanfovx for c in cams), tanfovy=tuple(c.tanfovy for c in cams),
            vis=torch.stack([item_vis(b) for b in batch]),
            width=cams[0].image_width, height=cams[0].image_height)

    return args, SimpleNamespace(device=device, group=group, bind=bind, dataset=dataset,
                                 mesh_f=mesh_f, net=net, state=state, start_epoch=start_epoch,
                                 make_item=make_item, run_args=run_args,
                                 stage3_path=stage3_path, n_texels=n_texels)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import parallel
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.training.checkpoints import (s3_state_to_jax, save_s3_ckpt,
                                                                  wait_for_saves)
    from gaussian_garments_tpu_torch.utils.logging import MetricLogger
    from gaussian_garments_tpu_torch.utils.quality import image_metrics

    args, run = prepare(argv)
    device, bind, dataset, mesh_f, net = run.device, run.bind, run.dataset, run.mesh_f, run.net
    state, make_item, stage3_path, group = run.state, run.make_item, run.stage3_path, run.group
    main_rank = parallel.is_main(group)
    say = print if main_rank else (lambda *a, **k: None)

    kw = dict(sh_degree=args.sh_degree)
    step_pre = S3.make_s3_step(net, run.run_args, train_gaussians=False, group=group, **kw)
    step_full = S3.make_s3_step(net, run.run_args, train_gaussians=True, group=group, **kw)
    eval_fn = S3.make_s3_eval(net, **kw)
    metrics_log = MetricLogger(str(stage3_path / "logs" / "train.jsonl") if main_rank else None)
    stats = {"steps": {"pre": {"n": 0, "seconds": 0.0}, "full": {"n": 0, "seconds": 0.0}},
             "losses": [], "eval": [], "n_items": len(dataset), "n_texels": run.n_texels}

    def eval_quality() -> dict:
        """PSNR/SSIM on held-out llffhold items, rendered by rank 0. Every
        rank loads the items, so that each draws the same backgrounds."""
        n = min(args.eval_items, len(dataset.eval_collection))
        acc = {}
        for j in range(n):
            entry = dataset.eval_item(j)
            if not main_rank:
                continue
            it_ = make_item([entry])
            img = eval_fn(state, bind, mesh_f, it_)[0]
            for k, v in image_metrics(img, it_.image[0], it_.mask[0]).items():
                acc[k] = acc.get(k, 0.0) + v
        return {f"eval_{k}": v / n for k, v in acc.items()}

    def log_quality(step: int, epoch: int) -> None:
        q = eval_quality()
        if q:
            metrics_log.log(step, q, epoch=epoch)
            stats["eval"].append({"step": step, "epoch": epoch, **q})
            say(f"[epoch {epoch}] " + " ".join(f"{k}={v:.3f}" for k, v in q.items()))

    def save(epoch: int, mid_epoch: bool = False) -> None:
        if main_rank:
            save_s3_ckpt(stage3_path, epoch=epoch, active_sh_degree=args.sh_degree,
                         async_save=mid_epoch and args.ckpt_backend == "orbax",
                         **s3_state_to_jax(state))

    if args.eval_only:
        q = eval_quality()
        say("EVAL_ONLY " + json.dumps({k: round(float(v), 4) for k, v in q.items()}),
            flush=True)
        metrics_log.close()
        stats["eval"].append(q)
        parallel.teardown(group)
        return stats

    b = args.items_per_step
    global_it = 0
    for epoch in range(run.start_epoch, args.epochs + 1):
        dataset.reshuffle(epoch)     # reference DataLoader(shuffle=True), s3:99
        for it in range(0, len(dataset), b):
            batch = [dataset[j % len(dataset)] for j in range(it, it + b)]
            item = make_item(parallel.shard(batch, group))
            kind = "pre" if epoch == 1 and it < args.pre_train_iterations else "full"
            t0 = time.perf_counter()
            state, loss_dict = (step_pre if kind == "pre" else step_full)(state, bind, mesh_f,
                                                                         item)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats["steps"][kind]["n"] += 1
            stats["steps"][kind]["seconds"] += time.perf_counter() - t0
            global_it += 1
            losses = {k: float(v) for k, v in loss_dict.items()}
            stats["losses"].append({"epoch": epoch, "it": it, "kind": kind, **losses})
            if it % 100 == 0:
                say(f"[epoch {epoch} iter {it}/{len(dataset)}] "
                      + " ".join(f"{k}={v:.5f}" for k, v in losses.items()))
                metrics_log.log(global_it, losses, epoch=epoch)
            # debug texture panels every save_iterations/5 items
            if main_rank and it % max(args.save_iterations // 5, 1) == 0:
                _save_debug_textures(net, state, bind, mesh_f, item, stage3_path, epoch, it)
            if it > 0 and it % args.save_iterations == 0:
                save(epoch, mid_epoch=True)
                log_quality(global_it, epoch)
        save(epoch)
        log_quality(global_it, epoch)
    metrics_log.close()
    wait_for_saves()
    parallel.teardown(group)
    say("\nTraining complete.")
    return stats


if __name__ == "__main__":
    main()
