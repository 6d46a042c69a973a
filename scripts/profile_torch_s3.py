"""Where the time of one stage-3 step goes, for the PyTorch port on one NVIDIA
GPU.

    python scripts/profile_torch_s3.py [--unet_bf16]

Builds a stage-3 item at the width of ``chip_smoke.py``'s s3 phase: a
synthetic 64×64 sheet (7,938 faces) bound at texture 512 (262,144 texel
splats, SH degree 3, log-scale −4.5, opacity sigmoid(2)), its baked AO and
normal textures, and the first camera of a ring of 12 at 940×1280 with its
ground-truth render; the StyleUNet at full width with seeded random weights.
Per step kind (``pre``: the net only; ``full``: the net and the splats): 5
warm-up steps, 3 steps timed on the host clock (the wall time per step), then
3 steps under ``torch.profiler`` (the device time per step, the sum of every
kernel's device time, and the kernels per step). Prints those, the device's
busy share of the wall time, and a table of the ops that take the most
device time. ``--unet_bf16`` runs the StyleUNet in bf16 over float32 master
weights, as ``s3_appearance --unet_bf16`` does. Imports nothing of JAX.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_s2 import device_us, kernel_events  # noqa: E402

W, H, NX, N_CAMS, TEXTURE, SH_DEGREE, WARM, REPS = 940, 1280, 64, 12, 512, 3, 5, 3


def build(dev, act_dtype=torch.float32):
    """(net, state, bind, mesh_f, item, args) of the scene in the module doc."""
    from argparse import ArgumentParser, Namespace

    from gaussian_garments_tpu_torch.config import OptimizationParams
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.data.baker import bake_textures
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    verts, faces, uvs = syn.make_cloth_template(NX, NX)
    colors = syn.face_checker_colors(faces, verts)
    ring = dict(radius=0.5, height=2.0)
    fx = syn.fit_focal(verts, n=N_CAMS, **ring, width=W, height_px=H, cover=1.1)
    cam = syn.render_ground_truth(syn.make_camera_ring(N_CAMS, **ring, fx=fx, width=W,
                                                       height_px=H, device=dev)[:1],
                                  verts, faces, colors)[0]
    bind, _ = AG.build_binding(uvs, faces, TEXTURE, device=dev)
    n = bind.binding.shape[0]
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    splats = G.GaussianParams(
        xyz=t(np.zeros((n, 3))), features_dc=t(rng.randn(n, 1, 3) * 0.1),
        features_rest=t(np.zeros((n, (SH_DEGREE + 1) ** 2 - 1, 3))),
        scaling=t(np.full((n, 3), -4.5)), rotation=t(np.tile([[1.0, 0, 0, 0]], (n, 1))),
        opacity=t(np.full((n, 1), 2.0)))
    amb, nrm = bake_textures(bind, verts, faces)
    mesh_f = torch.as_tensor(faces, device=dev)
    item = S3.S3Item(
        image=cam.original_image[None], mask=cam.gt_alpha_mask[None],
        bg=t(rng.rand(1, 3)), mesh_v=t(verts[None]), ambient=t(amb[None]), normal=t(nrm[None]),
        world_view=cam.world_view_transform[None], full_proj=cam.full_proj_transform[None],
        campos=cam.camera_center[None], tanfovx=(cam.tanfovx,), tanfovy=(cam.tanfovy,),
        width=W, height=H)
    with torch.no_grad():
        vis = AG.get_visible_mask_depth(bind, item.mesh_v[0], mesh_f, item.world_view[0],
                                        item.full_proj[0], image_width=256, image_height=256)
    item.vis = vis[None].to(torch.float32)
    net = AvatarNet(texture_size=TEXTURE, sh_degree=SH_DEGREE,
                    generator=torch.Generator().manual_seed(0), act_dtype=act_dtype).to(dev)
    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    args = Namespace(**{**vars(opt), "lr_init": 5e-4})
    return net, S3.init_state(net, splats), bind, mesh_f, item, args


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    from torch.profiler import ProfilerActivity, profile

    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.training import s3 as S3

    pin_full_f32()
    bf16 = "--unet_bf16" in sys.argv[1:]
    net, state, bind, mesh_f, item, args = build(
        torch.device("cuda", 0), torch.bfloat16 if bf16 else torch.float32)
    vis = item.vis[0]
    print(f"StyleUNet in {'bf16' if bf16 else 'float32'}; {bind.binding.shape[0]} texel splats ({int(vis.sum())} visible), texture {TEXTURE}, "
          f"SH {SH_DEGREE}, {sum(v.numel() for v in state.net_params.values())} net "
          f"parameters, {W}x{H}")

    for kind in ("pre", "full"):
        step = S3.make_s3_step(net, args, sh_degree=SH_DEGREE, train_gaussians=kind == "full")
        s = state
        for _ in range(WARM):
            s, _ = step(s, bind, mesh_f, item)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            s, _ = step(s, bind, mesh_f, item)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                s, _ = step(s, bind, mesh_f, item)
            torch.cuda.synchronize()
        events = kernel_events(prof)
        dev_s = sum(device_us(e) for e in events) / 1e6 / REPS
        launches = sum(e.count for e in events) / REPS
        print(f"{kind}: wall {wall * 1e3:.3f} ms/step, device {dev_s * 1e3:.3f} ms/step, "
              f"device busy {dev_s / wall:.3f} of the wall time, {launches:.0f} kernels/step "
              f"(mean of {REPS} profiled steps)")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                        max_name_column_width=60))


if __name__ == "__main__":
    main()
