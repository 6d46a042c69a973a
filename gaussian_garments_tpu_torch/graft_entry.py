"""Entry points of the port beside its drivers: the forward render and the
multi-process dry run.

Counterpart of the repo's ``__graft_entry__.py``:

- ``entry()`` (``__graft_entry__.py:37``): ``(fn, example_args)``, the
  forward render of the mesh-bound model;
- ``dryrun_multichip(n)`` (``:53``, ``_dryrun_s3`` ``:130``): n ranks of a
  gloo group on the CPU, each a new process, run the three stage-2 step
  shapes (template phase 1, template phase 2 with the body-collision
  energies, sequence) on their shard of an n-camera batch, then the stage-3
  item step, at the JAX dry run's shapes; it asserts finite losses and the
  ``collision`` term.

The forward entry runs on the card unless the caller passes ``--device
cpu``; the dry run's ranks are gloo processes on the CPU.

    python -m gaussian_garments_tpu_torch.graft_entry [--n 2] [--device cpu]
"""
from __future__ import annotations

import hashlib
from argparse import ArgumentParser, Namespace
from typing import Optional, Sequence

import numpy as np
import torch


def default_opt(**overrides):
    """The optimisation flags' defaults, with ``overrides``."""
    from gaussian_garments_tpu_torch.config import OptimizationParams

    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    return Namespace(**{**vars(opt), **overrides})


def build_scene(n_cams: int = 2, nx: int = 8, ny: int = 8, res: int = 64, device=None):
    """The JAX dry run's scene (``__graft_entry__.py:16``): a stage-2 state of
    one splat per face of a synthetic sheet and its camera batch."""
    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2

    device = resolve_device(device)
    cams, verts, faces, uvs, colors = syn.make_scene(n_cams=n_cams, nx=nx, ny=ny, width=res,
                                                     height=res, device=device)
    params, aux, binding, _ = MG.create_from_template(verts, faces, colors, max_sh_degree=0,
                                                      device=device)
    state = S2.init_state(params, aux, binding, MM.create(verts, faces, device=device))
    return state, BatchedCameras.from_cameras(cams)


def entry(device=None):
    """(fn, example_args): ``fn(params, mesh_v, cams)`` renders the mesh-bound
    Gaussian model, (B,3,H,W)."""
    from gaussian_garments_tpu_torch.renderer import render_batch
    from gaussian_garments_tpu_torch.training.s2 import splat_bundle

    state, batch = build_scene(device=device)

    def fn(params, mesh_v, cams):
        bundle = splat_bundle(params, state.binding, state.aux.alive, mesh_v, state.mesh.f, 0)
        return render_batch(cams, bundle, torch.zeros(3, device=mesh_v.device))["render"]

    return fn, (state.params, state.mesh.v, batch)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _dryrun_rank(n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``: the three s2 step shapes on this
    rank's cameras of an n-camera batch, then the s3 item step on its items."""
    from gaussian_garments_tpu_torch import parallel
    from gaussian_garments_tpu_torch.data import synthetic as syn
    from gaussian_garments_tpu_torch.data.baker import bake_textures
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models import mesh_model as MM
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.training import s3 as S3

    device, group = parallel.current(torch.device("cpu"))
    state, batch = build_scene(n_cams=n_devices, nx=6, ny=6, res=32, device="cpu")
    lo, hi = parallel.shard_bounds(n_devices, group.rank, group.world)
    cams = BatchedCameras(world_view=batch.world_view[lo:hi], full_proj=batch.full_proj[lo:hi],
                          campos=batch.campos[lo:hi], tanfovx=batch.tanfovx[lo:hi],
                          tanfovy=batch.tanfovy[lo:hi], image=batch.image[lo:hi],
                          mask=batch.mask[lo:hi], width=batch.width, height=batch.height)
    v = state.mesh.v.cpu().numpy()
    f = state.mesh.f.cpu().numpy()
    state_body = state.replace(mesh=MM.init_body(state.mesh, v - np.float32([0, 0, 0.05]), f,
                                                 np.zeros(len(v), np.int64)))
    opt = default_opt()
    out = {}
    for mode, use_body, st in (("template_p1", False, state), ("template_p2", True, state_body),
                               ("seq", False, state)):
        step = S2.make_s2_step(opt, mode=mode, use_body=use_body, group=group)
        _, loss, metrics = step(st, cams, torch.zeros(3), 1.6e-4, 1.6e-4)
        out[mode] = {"loss": float(metrics["loss"]),
                     "losses": {k: float(x) for k, x in loss.items()}}

    # the s3 item step, items sharded over the ranks (``__graft_entry__.py:130``)
    res, tex = 32, 32
    cams3, verts, faces, uvs, _ = syn.make_scene(n_cams=max(2, n_devices), nx=6, ny=6,
                                                 width=res, height=res, device="cpu")
    bind, _ = AG.build_binding(uvs, faces, tex, device="cpu")
    n = bind.binding.shape[0]
    rng = np.random.RandomState(0)
    splats = G.GaussianParams(
        xyz=torch.zeros((n, 3)),
        features_dc=torch.as_tensor(rng.randn(n, 1, 3).astype(np.float32) * 0.1),
        features_rest=torch.zeros((n, 3, 3)), scaling=torch.full((n, 3), -4.5),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1), opacity=torch.full((n, 1), 2.0))
    amb, nrm = bake_textures(bind, verts, faces, n_samples=4)
    take = parallel.shard([cams3[i % len(cams3)] for i in range(n_devices)], group)
    b = len(take)
    item = S3.S3Item(
        image=torch.stack([c.original_image for c in take]),
        mask=torch.stack([c.gt_alpha_mask for c in take]), bg=torch.zeros((b, 3)),
        mesh_v=torch.as_tensor(verts)[None].repeat(b, 1, 1),
        ambient=torch.as_tensor(amb)[None].repeat(b, 1, 1, 1),
        normal=torch.as_tensor(nrm)[None].repeat(b, 1, 1, 1),
        world_view=torch.stack([c.world_view_transform for c in take]),
        full_proj=torch.stack([c.full_proj_transform for c in take]),
        campos=torch.stack([c.camera_center for c in take]),
        tanfovx=tuple(c.tanfovx for c in take), tanfovy=tuple(c.tanfovy for c in take),
        width=res, height=res)
    net = AvatarNet(texture_size=tex, sh_degree=1, generator=torch.Generator().manual_seed(0))
    s3_state = S3.init_state(net, splats)
    step = S3.make_s3_step(net, default_opt(lr_init=5e-4), sh_degree=1,
                           vis_raster_hw=(res, res), group=group)
    new_state, loss = step(s3_state, bind, torch.as_tensor(faces.astype(np.int64)), item)
    out["s3"] = {"losses": {k: float(x) for k, x in loss.items()},
                 "net_sha256": hashlib.sha256(b"".join(
                     v.numpy().tobytes() for _, v in sorted(new_state.net_params.items()))
                 ).hexdigest()}
    return out


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """The sharded stage-2 and stage-3 steps on ``n_devices`` gloo ranks (new
    CPU processes). Raises unless every loss is finite, the template phase-2
    step carries the collision energy, and every rank ends with the same
    losses and net. Returns rank 0's result."""
    from gaussian_garments_tpu_torch import parallel

    results = parallel.spawn(_dryrun_rank, n_devices, (n_devices,), timeout=timeout)
    r0 = results[0]
    for mode in ("template_p1", "template_p2", "seq"):
        if not np.isfinite(r0[mode]["loss"]):
            raise FloatingPointError(f"sharded s2 {mode} step produced a non-finite loss")
        print(f"dryrun_multichip({n_devices}) s2 {mode} OK: loss={r0[mode]['loss']:.5f}, "
              f"losses={ {k: round(v, 5) for k, v in r0[mode]['losses'].items()} }")
    if "collision" not in r0["template_p2"]["losses"]:
        raise AssertionError("the template_p2 step must include the body-collision energy; got "
                             f"{list(r0['template_p2']['losses'])}")
    if not np.isfinite(sum(r0["s3"]["losses"].values())):
        raise FloatingPointError("sharded s3 step produced a non-finite loss")
    if any(r != r0 for r in results[1:]):
        raise AssertionError("the ranks disagree after the reduced steps")
    print(f"dryrun_multichip({n_devices}) s3 OK: "
          f"losses={ {k: round(v, 5) for k, v in r0['s3']['losses'].items()} }")
    print(f"dryrun_multichip({n_devices}) OK")
    return r0


def main(argv: Optional[Sequence[str]] = None) -> None:
    from gaussian_garments_tpu_torch import pin_full_f32, resolve_device

    ap = ArgumentParser(description="the port's dry run and forward entry point")
    ap.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    ap.add_argument("--device", default=None,
                    help="device of the forward entry point (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pin_full_f32()
    dryrun_multichip(args.n)
    fn, example = entry(device=device)
    print("entry OK", tuple(fn(*example).shape))


if __name__ == "__main__":
    main()
