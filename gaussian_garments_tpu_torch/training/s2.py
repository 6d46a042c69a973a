"""Stage-2 registration trainer: one optimisation step and the host edits
between steps (port of ``gaussian_garments_tpu/training/s2.py``; reference
the inline loop of ``s2_registration.py:196-338``).

Each step: face frames → splat bundle → ``render_batch`` over a batch of
cameras (projection with a ``screen_offset`` hook → binning → the CUDA
compositor forward and backward) → masked L1 and SSIM → xyz/scale hinges
(template phase 1) or cloth energies (template phase 2 and sequence mode) →
``torch.autograd.grad`` → Adam on the splats or on the vertices, plus the
densification statistics. Densify, prune and opacity reset stay host edits
between steps (``models/mesh_gaussian.py``, ``models/gaussian.py``). Spans
(``utils/logging.span``) mark the step and its layers: ``bundle``, ``loss``,
``energies``, ``backward``, ``adam`` here, ``project``, ``bin`` and ``sync``
below.

With a ``group`` (``parallel.Group``, the counterpart of the JAX step's
``axis_name``) each rank renders its shard of the camera batch and the step
reduces what the JAX step reduces, where it does (``training/s2.py:207-262``):
the mean of the splat or vertex gradients and of the losses, the sum of the
densification increments, the maximum of the radii, and the metrics. The
densification statistic ``|∂L/∂mean2D| · k`` uses the rank's own screen
gradient and camera count, before any reduction, as the JAX step does.

A step is a host part and a device part. The host part advances the host
ints (``iteration``, the Adam step), makes the per-step numbers (the learning
rate, the bias corrections) and builds the new state; the device part takes
the pieces of the state it reads and returns tensors. On the card, without a
``group``, the vertex modes (``template_p2``, ``seq``: fixed shapes through a
frame) replay the device part as one CUDA graph (``training/graph``),
captured at the first call of each key of its arguments, so the host issues
one launch instead of ~5,000; ``step.eager`` calls it uncaptured, as
``template_p1`` (its splat count changes at every densify), data parallelism
and CPU tensors do. Counters ``s2_graph.capture`` and ``s2_graph.replay``
count the two.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.models import mesh_model as MM
from gaussian_garments_tpu_torch.models.adam import (TensorAdam, bias_corrections,
                                                     tensor_adam_init, tensor_adam_step,
                                                     to_device)
from gaussian_garments_tpu_torch.parallel import Group, pmax, pmean, psum
from gaussian_garments_tpu_torch.renderer import (BatchedCameras, RasterConfig, SplatBundle,
                                                  render_batch)
from gaussian_garments_tpu_torch.training import graph
from gaussian_garments_tpu_torch.utils import logging as log
from gaussian_garments_tpu_torch.utils.losses import l1_loss, safe_norm, ssim

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


def s2_losses(params: G.GaussianParams, binding: torch.Tensor, alive: torch.Tensor,
              mesh: MM.MeshState, screen_offset: torch.Tensor, cams: BatchedCameras,
              bg: torch.Tensor, opt, *, mode: str, use_body: bool, active_sh_degree: int = 0,
              raster_cfg: RasterConfig = RasterConfig()):
    """(total, loss_dict, render outputs) of one camera batch
    (``training/s2.py:_s2_losses``)."""
    with log.span("bundle"):
        bundle = splat_bundle(params, binding, alive, mesh.v, mesh.f, active_sh_degree)
    out = render_batch(cams, bundle, bg, screen_offset=screen_offset, config=raster_cfg)
    image = out["render"]
    mask = cams.mask if opt.only_foreground_loss else None
    with log.span("loss"):
        loss: Dict[str, torch.Tensor] = {
            "img": l1_loss(image, cams.image, mask) * (1.0 - opt.lambda_dssim),
            # the reference's quirk, kept: 1 - ssim·λ, not (1 - ssim)·λ
            "ssim": 1.0 - ssim(image, cams.image, mask) * opt.lambda_dssim,
        }
        if mode == "template_p1":
            vis = out["visibility_filter"] & alive[None, :]
            xyz_excess = torch.relu(safe_norm(params.xyz, dim=1) - opt.threshold_xyz)
            loss["xyz"] = _masked_mean(xyz_excess, vis).mean() * opt.lambda_xyz
            scale_excess = safe_norm(torch.relu(torch.exp(params.scaling)
                                                - opt.threshold_scale), dim=1)
            loss["scale"] = _masked_mean(scale_excess, vis).mean() * opt.lambda_scale
    if mode != "template_p1":
        # the reference adds the cloth energies only while mesh.v is optimized
        with log.span("energies"):
            loss.update(MM.get_energy_loss(mesh, opt, use_body and mesh.has_body))
    return sum(loss.values()), loss, out


def _runs_as_graph(mode: str, mesh_v: torch.Tensor, group: Optional[Group]) -> bool:
    """Whether a step replays a graph: a vertex mode (``template_p1``'s
    splat count changes at every densify), on the card, without a ``group``
    (a captured collective is not shown to work)."""
    return mode != "template_p1" and group is None and mesh_v.is_cuda


def make_s2_step(opt, *, mode: str, use_body: bool, active_sh_degree: int = 0,
                 raster_cfg: RasterConfig = RasterConfig(),
                 group: Optional[Group] = None) -> Callable:
    """One stage-2 step, ``step(state, cams, bg, xyz_lr, vert_lr) -> (state,
    loss_dict, metrics)``:

    - template_p1: the splats only, plus densification statistics, no cloth
      energies (the reference creates mesh.v with requires_grad=False);
    - template_p2: the vertices only, with the energies;
    - seq: the vertices only, with the energies.

    With a ``group``, ``cams`` is this rank's shard and every output is the
    same on every rank. ``step.graph_call`` gives what a vertex step hands
    the graph, ``step.eager`` the step never captured (see the module doc).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    optimize_splats = mode == "template_p1"
    graphs = graph.Graphs("s2_graph")

    def step(state: S2State, cams: BatchedCameras, bg: torch.Tensor, xyz_lr, vert_lr):
        if not _runs_as_graph(mode, state.mesh.v, group):
            return eager(state, cams, bg, xyz_lr, vert_lr)
        with log.span("step"):
            return _finish(state, graphs(*graph_call(state, cams, bg, vert_lr)))

    def graph_call(state: S2State, cams: BatchedCameras, bg: torch.Tensor, vert_lr):
        """``graphs``' arguments for a vertex-mode step: the device part, its
        arguments with the per-step numbers as floats, and the mode."""
        bcs = lambda adam: tuple(map(float, bias_corrections(adam.step + 1)))
        return _device, _device_args(state, cams, bg, float(vert_lr), bcs), (mode,)

    def eager(state: S2State, cams: BatchedCameras, bg: torch.Tensor, xyz_lr, vert_lr):
        with log.span("step"):
            bcs = lambda adam: to_device(bias_corrections(adam.step + 1), state.mesh.v.device)
            lr = xyz_lr if optimize_splats else vert_lr
            return _finish(state, _device(*_device_args(state, cams, bg, lr, bcs)))

    def _device_args(state: S2State, cams: BatchedCameras, bg: torch.Tensor, lr, bcs) -> tuple:
        """What the device part reads of the state and the step: ``bcs``
        gives an Adam's bias corrections of its next step."""
        adam = state.splat_adam if optimize_splats else state.vert_adam
        return (state.params, state.binding, state.aux.alive,
                state.aux if optimize_splats else None, state.mesh, (adam.mu, adam.nu), cams,
                bg, lr, bcs(adam))

    def _device(params: G.GaussianParams, binding: torch.Tensor, alive: torch.Tensor,
                aux: Optional[G.GaussianAux], mesh: MM.MeshState, moments: tuple,
                cams: BatchedCameras, bg: torch.Tensor, lr, bcs):
        """One Adam step of the splats (``template_p1``, adding to the
        densification statistics ``aux``; None otherwise) or of the vertices,
        from their ``moments``. Returns (new splats or vertices, their
        moments, new ``aux``, loss_dict, metrics)."""
        n_cams = cams.world_view.shape[0]
        leaf_params = G.GaussianParams(**{
            k: getattr(params, k).detach().requires_grad_(optimize_splats)
            for k in G.PARAM_NAMES})
        mesh_v = mesh.v.detach().requires_grad_(not optimize_splats)
        screen = torch.zeros((n_cams, params.xyz.shape[0], 2), device=params.xyz.device,
                             requires_grad=optimize_splats)
        total, loss, out = s2_losses(leaf_params, binding, alive, mesh.replace(v=mesh_v), screen,
                                     cams, bg, opt, mode=mode, use_body=use_body,
                                     active_sh_degree=active_sh_degree, raster_cfg=raster_cfg)
        if optimize_splats:
            leaves = [getattr(leaf_params, k) for k in G.PARAM_NAMES] + [screen]
        else:
            leaves = [mesh_v]
        with log.span("backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
        loss = {k: v.detach() for k, v in loss.items()}
        total = total.detach()
        # the screen gradient stays the rank's own (the JAX step's g_screen)
        n_reduced = len(grads) - 1 if optimize_splats else len(grads)
        g_red, loss, total = pmean((list(grads[:n_reduced]), loss, total), group)
        grads = list(g_red) + list(grads[n_reduced:])

        radii_max = out["radii"].max().float()
        n_overflow = out["raster_aux"]["n_overflow"].sum().float()
        new_aux = None
        # the step count stays on the host: ``bcs`` carry it
        with torch.no_grad(), log.span("adam"):
            if optimize_splats:
                g_params = G.GaussianParams(**dict(zip(G.PARAM_NAMES, grads[:-1])))
                lrs = {"xyz": lr, "features_dc": opt.feature_lr,
                       "features_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
                       "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
                new, adam = G.adam_step(params, g_params, G.AdamState(0, *moments), lrs, bcs=bcs)
                # densification statistics (reference :312-317): the loss is a
                # batch mean, so k · |∂L/∂mean2D| recovers per-camera norms
                vis = out["visibility_filter"] & alive[None, :]
                gnorm = torch.linalg.norm(grads[-1], dim=-1) * n_cams
                accum_inc = torch.where(vis, gnorm, torch.zeros_like(gnorm)).sum(0)
                denom_inc = vis.sum(0).to(torch.float32)
                radii_inc = torch.where(vis, out["radii"],
                                        torch.zeros_like(out["radii"])).amax(0).float()
                accum_inc, denom_inc, n_overflow = psum((accum_inc, denom_inc, n_overflow),
                                                        group)
                radii_inc, radii_max = pmax((radii_inc, radii_max), group)
                new_aux = aux.replace(
                    xyz_gradient_accum=aux.xyz_gradient_accum + accum_inc[:, None],
                    denom=aux.denom + denom_inc[:, None],
                    max_radii2d=torch.maximum(aux.max_radii2d, radii_inc))
            else:
                new, adam = tensor_adam_step(mesh.v, grads[0], TensorAdam(0, *moments), lr,
                                             bcs=bcs)
                n_overflow = psum(n_overflow, group)
                radii_max = pmax(radii_max, group)
        metrics = {"radii_max": radii_max, "n_overflow": n_overflow, "loss": total}
        return new, (adam.mu, adam.nu), new_aux, loss, metrics

    def _finish(state: S2State, out) -> tuple:
        """(state, loss_dict, metrics) from the device part's outputs; the
        step and iteration counters advance here, as host ints."""
        new, (mu, nu), aux, loss, metrics = out
        if optimize_splats:
            kw = dict(params=new, splat_adam=G.AdamState(state.splat_adam.step + 1, mu, nu),
                      aux=aux)
        else:
            kw = dict(mesh=state.mesh.replace(v=new),
                      vert_adam=TensorAdam(state.vert_adam.step + 1, mu, nu))
        return state.replace(iteration=state.iteration + 1, **kw), loss, metrics

    step.eager, step.graph_call = eager, graph_call
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
