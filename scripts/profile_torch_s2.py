"""Where the time of one stage-2 iteration goes, for the PyTorch port on one
NVIDIA GPU.

    python scripts/profile_torch_s2.py

Builds the stage-2 scene of ``chip_smoke.py`` (a synthetic 64×64 sheet of
7,938 faces seen by a ring of 12 cameras at 940×1280; the first 4 are the
batch) and the template state (one splat per face). Per mode: 5 warm-up
steps, 3 steps timed on the host clock (the wall time per step), then 3 steps
under ``torch.profiler`` (the device time per step, the sum of every kernel's
device time, and the kernels per step). Prints those, the device's busy share
of the wall time, and a table of the ops that take the most device time.
Imports nothing of JAX.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, NX, N_CAMS, PER_STEP, WARM, REPS = 940, 1280, 64, 12, 4, 5, 3


def device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def kernel_events(prof):
    """The profile's device-side events (kernels, copies, sets): an operator's
    own entry also carries its kernels' time, so summing every entry would
    count it twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    from argparse import ArgumentParser

    from torch.profiler import ProfilerActivity, profile

    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.config import OptimizationParams
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2

    pin_full_f32()
    dev = torch.device("cuda", 0)
    verts, faces, _ = syn.make_cloth_template(NX, NX)
    colors = syn.face_checker_colors(faces, verts)
    ring = dict(radius=0.5, height=2.0)
    fx = syn.fit_focal(verts, n=N_CAMS, **ring, width=W, height_px=H, cover=1.1)
    cams = syn.make_camera_ring(N_CAMS, **ring, fx=fx, width=W, height_px=H, device=dev)
    cams = syn.render_ground_truth(cams[:PER_STEP], verts, faces, colors)
    batch = BatchedCameras.from_cameras(cams)
    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    params, aux, binding, _ = MG.create_from_template(verts, faces, colors, max_sh_degree=0,
                                                      device=dev)
    state = S2.init_state(params, aux, binding, MM.create(verts, faces, device=dev))
    bg = torch.zeros(3, device=dev)
    print(f"{len(faces)} splats, {PER_STEP} cameras per step at {W}x{H}")

    for mode in S2.MODES:
        step = S2.make_s2_step(opt, mode=mode, use_body=False)
        s = state
        for _ in range(WARM):
            s, _, _ = step(s, batch, bg, 1e-4, 1e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            s, _, _ = step(s, batch, bg, 1e-4, 1e-4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                s, _, _ = step(s, batch, bg, 1e-4, 1e-4)
            torch.cuda.synchronize()
        events = kernel_events(prof)
        dev_s = sum(device_us(e) for e in events) / 1e6 / REPS
        launches = sum(e.count for e in events) / REPS
        print(f"{mode}: wall {wall * 1e3:.3f} ms/step, device {dev_s * 1e3:.3f} ms/step, "
              f"device busy {dev_s / wall:.3f} of the wall time, {launches:.0f} kernels/step "
              f"(mean of {REPS} profiled steps)")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                        max_name_column_width=60))


if __name__ == "__main__":
    main()
