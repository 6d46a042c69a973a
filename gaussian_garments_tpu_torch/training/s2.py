"""Stage-2 registration trainer: one optimisation step and the host edits
between steps (port of ``gaussian_garments_tpu/training/s2.py``; reference
the inline loop of ``s2_registration.py:196-338``).

Each step: face frames → splat bundle → ``render_batch`` over a batch of
cameras (projection with a ``screen_offset`` hook → binning → the CUDA
compositor forward and backward) → masked L1 and SSIM → xyz/scale hinges
(template phase 1) or cloth energies (template phase 2 and sequence mode) →
``torch.autograd.grad`` → Adam on the splats or on the vertices, plus the
densification statistics. Densify, prune and opacity reset stay host edits
between steps (``models/mesh_gaussian.py``, ``models/gaussian.py``).

The JAX step's ``axis_name`` (data parallelism) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.models import mesh_model as MM
from gaussian_garments_tpu_torch.models.adam import TensorAdam, tensor_adam_init, tensor_adam_step
from gaussian_garments_tpu_torch.renderer import (BatchedCameras, RasterConfig, SplatBundle,
                                                  render_batch)
from gaussian_garments_tpu_torch.utils.losses import l1_loss, ssim

MODES = ("template_p1", "template_p2", "seq")


@dataclasses.dataclass
class S2State:
    """Everything a stage-2 step updates (one frame's optimisation state)."""

    params: G.GaussianParams
    aux: G.GaussianAux
    splat_adam: G.AdamState
    binding: torch.Tensor   # (M,) int64
    mesh: MM.MeshState
    vert_adam: TensorAdam
    iteration: int = 0

    def replace(self, **kw) -> "S2State":
        return dataclasses.replace(self, **kw)


def init_state(params: G.GaussianParams, aux: G.GaussianAux, binding,
               mesh: MM.MeshState) -> S2State:
    return S2State(params=params, aux=aux, splat_adam=G.adam_init(params),
                   binding=torch.as_tensor(np.asarray(binding), dtype=torch.int64,
                                           device=params.xyz.device),
                   mesh=mesh, vert_adam=tensor_adam_init(mesh.v))


def splat_bundle(params: G.GaussianParams, binding: torch.Tensor, alive: torch.Tensor,
                 mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                 active_sh_degree: int = 0) -> SplatBundle:
    """World-space splats of mesh-bound local parameters (one shared gather
    of the face-frame table)."""
    frames = MG.compute_face_frames(mesh_v, mesh_f)
    rows = MG.gather_frame_rows(frames, binding)
    return SplatBundle(
        means3d=MG.world_xyz(params, binding, frames, rows=rows),
        opacity=G.get_opacity(params) * alive[:, None].to(params.opacity.dtype),
        scales=MG.world_scaling(params, binding, frames, rows=rows),
        rotations=MG.world_rotation(params, binding, frames, rows=rows),
        shs=G.get_features(params), active_sh_degree=active_sh_degree)


def _masked_mean(x: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(M,) values, (B,M) masks -> (B,) means over each mask."""
    m = vis.to(x.dtype)
    return (x[None] * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero gradient at 0: the hinge losses sit exactly at 0 at
    the start (local xyz = 0)."""
    sq = (x * x).sum(dim)
    return torch.sqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq)) * (sq != 0.0)


def s2_losses(params: G.GaussianParams, mesh_v: torch.Tensor, screen_offset: torch.Tensor,
              state: S2State, cams: BatchedCameras, bg: torch.Tensor, opt, *, mode: str,
              use_body: bool, active_sh_degree: int = 0,
              raster_cfg: RasterConfig = RasterConfig()):
    """(total, loss_dict, render outputs) of one camera batch
    (``training/s2.py:_s2_losses``)."""
    mesh = state.mesh.replace(v=mesh_v)
    bundle = splat_bundle(params, state.binding, state.aux.alive, mesh_v, state.mesh.f,
                          active_sh_degree)
    out = render_batch(cams, bundle, bg, screen_offset=screen_offset, config=raster_cfg)
    image = out["render"]
    mask = cams.mask if opt.only_foreground_loss else None
    loss: Dict[str, torch.Tensor] = {
        "img": l1_loss(image, cams.image, mask) * (1.0 - opt.lambda_dssim),
        # the reference's quirk, kept: 1 - ssim·λ, not (1 - ssim)·λ
        "ssim": 1.0 - ssim(image, cams.image, mask) * opt.lambda_dssim,
    }
    if mode == "template_p1":
        vis = out["visibility_filter"] & state.aux.alive[None, :]
        xyz_excess = torch.relu(_safe_norm(params.xyz, dim=1) - opt.threshold_xyz)
        loss["xyz"] = _masked_mean(xyz_excess, vis).mean() * opt.lambda_xyz
        scale_excess = _safe_norm(torch.relu(torch.exp(params.scaling) - opt.threshold_scale),
                                  dim=1)
        loss["scale"] = _masked_mean(scale_excess, vis).mean() * opt.lambda_scale
    else:
        # the reference adds the cloth energies only while mesh.v is optimized
        loss.update(MM.get_energy_loss(mesh, opt, use_body and state.mesh.has_body))
    return sum(loss.values()), loss, out


def make_s2_step(opt, *, mode: str, use_body: bool, active_sh_degree: int = 0,
                 raster_cfg: RasterConfig = RasterConfig()) -> Callable:
    """One stage-2 step, ``step(state, cams, bg, xyz_lr, vert_lr) -> (state,
    loss_dict, metrics)``:

    - template_p1: the splats only, plus densification statistics, no cloth
      energies (the reference creates mesh.v with requires_grad=False);
    - template_p2: the vertices only, with the energies;
    - seq: the vertices only, with the energies.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    optimize_splats = mode == "template_p1"

    def step(state: S2State, cams: BatchedCameras, bg: torch.Tensor, xyz_lr, vert_lr):
        n_cams = cams.world_view.shape[0]
        params = G.GaussianParams(**{
            k: getattr(state.params, k).detach().requires_grad_(optimize_splats)
            for k in G.PARAM_NAMES})
        mesh_v = state.mesh.v.detach().requires_grad_(not optimize_splats)
        screen = torch.zeros((n_cams, params.xyz.shape[0], 2), device=params.xyz.device,
                             requires_grad=optimize_splats)
        total, loss, out = s2_losses(params, mesh_v, screen, state, cams, bg, opt, mode=mode,
                                     use_body=use_body, active_sh_degree=active_sh_degree,
                                     raster_cfg=raster_cfg)
        if optimize_splats:
            leaves = [getattr(params, k) for k in G.PARAM_NAMES] + [screen]
        else:
            leaves = [mesh_v]
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)

        new_state = state
        with torch.no_grad():
            if optimize_splats:
                g_params = G.GaussianParams(**dict(zip(G.PARAM_NAMES, grads[:-1])))
                lrs = {"xyz": xyz_lr, "features_dc": opt.feature_lr,
                       "features_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
                       "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
                new_params, new_adam = G.adam_step(state.params, g_params, state.splat_adam, lrs)
                # densification statistics (reference :312-317): the loss is a
                # batch mean, so k · |∂L/∂mean2D| recovers per-camera norms
                vis = out["visibility_filter"] & state.aux.alive[None, :]
                gnorm = torch.linalg.norm(grads[-1], dim=-1) * n_cams
                aux = state.aux
                new_aux = aux.replace(
                    xyz_gradient_accum=aux.xyz_gradient_accum
                    + torch.where(vis, gnorm, torch.zeros_like(gnorm)).sum(0)[:, None],
                    denom=aux.denom + vis.sum(0).to(torch.float32)[:, None],
                    max_radii2d=torch.maximum(aux.max_radii2d, torch.where(
                        vis, out["radii"], torch.zeros_like(out["radii"])).amax(0).float()))
                new_state = new_state.replace(params=new_params, splat_adam=new_adam,
                                              aux=new_aux)
            else:
                new_v, new_vert_adam = tensor_adam_step(state.mesh.v, grads[0], state.vert_adam,
                                                        vert_lr)
                new_state = new_state.replace(mesh=state.mesh.replace(v=new_v),
                                              vert_adam=new_vert_adam)
        new_state = new_state.replace(iteration=state.iteration + 1)
        metrics = {"radii_max": out["radii"].max().float(),
                   "n_overflow": out["raster_aux"]["n_overflow"].sum().float(),
                   "loss": total.detach()}
        return new_state, {k: v.detach() for k, v in loss.items()}, metrics

    return step


# ---------------------------------------------------------------------------
# host-side orchestration helpers
# ---------------------------------------------------------------------------

def densify_and_prune_state(state: S2State, opt, cameras_extent: float, max_screen_size,
                            binding_counter: np.ndarray,
                            rng: Optional[np.random.RandomState] = None):
    """Host structural edit between steps (reference :318-320). Returns
    (state, binding_counter, stats)."""
    params, aux, adam, binding, counter, stats = MG.densify_and_prune(
        state.params, state.aux, state.splat_adam, state.binding.cpu().numpy(), binding_counter,
        state.mesh.v.detach().cpu().numpy(), state.mesh.f.cpu().numpy(),
        max_grad=opt.densify_grad_threshold, min_opacity=0.005, extent=cameras_extent,
        max_screen_size=max_screen_size, percent_dense=opt.percent_dense, rng=rng)
    binding = torch.as_tensor(binding, dtype=torch.int64, device=state.binding.device)
    return state.replace(params=params, aux=aux, splat_adam=adam, binding=binding), counter, stats


def reset_opacity_state(state: S2State) -> S2State:
    with torch.no_grad():
        params, adam = G.reset_opacity(state.params, state.splat_adam)
    return state.replace(params=params, splat_adam=adam)
