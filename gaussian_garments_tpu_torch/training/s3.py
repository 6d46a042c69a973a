"""Stage-3 appearance trainer: one optimisation step and the eval render
(port of ``gaussian_garments_tpu/training/s3.py``; reference the inline loop
of ``s3_appearance.py:105-204``).

Per (sequence, frame, camera) item of a batch: pose the mesh → AvatarNet
predicts per-texel Δxyz and ΔSH from the baked AO and normal textures → the
texel splats go through ``renderer.render_batch`` (projection, binning, the
CUDA compositor forward and backward) on a zero background, masked by the
per-texel visibility, and the item's background is composited as
``img + bg·(1 − α)`` outside the kernel → masked L1 and SSIM plus the xyz,
scale and opacity hinges → ``torch.autograd.grad`` → Adam over the net and,
after pre-training, the splats. Spans (``utils/logging.span``) mark the step
and its layers: ``texels``, ``unet``, ``loss``, ``backward``, ``adam`` here,
``project``, ``bin`` and ``sync`` below.

The net is called functionally (``torch.func.functional_call``) on the
state's parameter and buffer dicts, so the state holds the weights and the
module only the computation; the dict keys are the Flax paths joined with
dots (``training/checkpoints.py`` converts both ways).

With a bf16 net (``AvatarNet(act_dtype=torch.bfloat16)``) the float
parameters and buffers are cast to bf16 where the net is applied
(``_cast_net_vars``); autograd through the cast hands float32 gradients to the
float32 masters that Adam keeps. With a dense binding, dead texels get zero
opacity and the hinges reduce over alive texels only, so the losses are the
compact layout's.

Not ported: the JAX package's ``make_s3_pair_counter`` and ``pair_budget``
probing (the port allocates pairs exactly, so there is no budget to size).

With a ``group`` (``parallel.Group``, the JAX step's ``axis_name``) each rank
trains on its shard of the items and the net and splat gradients and the
losses are averaged over the ranks before Adam (``training/s3.py:336-341``),
in one all-reduce.

A step is a host part and a device part. The host part advances the host
ints (``iteration``, both Adams' steps), makes the per-step numbers (the bias
corrections) and builds the new state; the device part takes the pieces of
the state it reads and returns tensors. On the card, without a ``group`` and
with every item's visibility given (``S3Item.vis``, as ``s3_appearance``
caches it), the device part replays as one CUDA graph (``training/graph``),
captured at the first call of each key of its arguments, so the host issues
one launch instead of ~5,700; binning lays its pairs out at their static
bound under capture (``ops/tiles``). ``step.eager`` calls it uncaptured, as
data parallelism (its collectives), a step that computes the visibility, and
CPU tensors do. Counters ``s3_graph.capture`` and ``s3_graph.replay`` count
the two.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.models.adam import (TreeAdam, bias_corrections, to_device,
                                                     tree_adam_init, tree_adam_step)
from gaussian_garments_tpu_torch.models.avatar_net import apply_shadow
from gaussian_garments_tpu_torch.parallel import Group, pmean
from gaussian_garments_tpu_torch.renderer import (BatchedCameras, RasterConfig, SplatBundle,
                                                  render_batch)
from gaussian_garments_tpu_torch.training import graph
from gaussian_garments_tpu_torch.utils import logging as log
from gaussian_garments_tpu_torch.utils.losses import l1_loss, safe_norm, ssim


@dataclasses.dataclass
class S3Item:
    """A batch of (sequence, frame, camera) items (leading axis = batch)."""

    image: torch.Tensor          # (B,3,H,W)
    mask: torch.Tensor           # (B,1,H,W)
    bg: torch.Tensor             # (B,3)
    mesh_v: torch.Tensor         # (B,V,3)
    ambient: torch.Tensor        # (B,1,res,res)
    normal: torch.Tensor         # (B,3,res,res)
    world_view: torch.Tensor     # (B,4,4)
    full_proj: torch.Tensor      # (B,4,4)
    campos: torch.Tensor         # (B,3)
    tanfovx: Tuple[float, ...]
    tanfovy: Tuple[float, ...]
    # per-texel visibility (B,G), a constant of the item that
    # s3_appearance caches; None computes it in the step
    vis: Optional[torch.Tensor] = None
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class S3State:
    net_params: Dict[str, torch.Tensor]
    net_buffers: Dict[str, torch.Tensor]
    splats: G.GaussianParams
    net_adam: TreeAdam
    splat_adam: G.AdamState
    iteration: int = 0

    def replace(self, **kw) -> "S3State":
        return dataclasses.replace(self, **kw)


def init_state(net: torch.nn.Module, splats: G.GaussianParams) -> S3State:
    """A fresh state from the net's current weights and the texel splats."""
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    buffers = {k: v.detach().clone() for k, v in net.named_buffers()}
    return S3State(net_params=params, net_buffers=buffers, splats=splats,
                   net_adam=tree_adam_init(params), splat_adam=G.adam_init(splats))


def splat_lrs(args) -> Dict[str, float]:
    """Reference AvatarNet.training_setup learning rates (avatar_net.py:40-49)."""
    return {"xyz": args.position_lr_init * 2.5, "features_dc": args.feature_lr,
            "features_rest": args.feature_lr / 20.0, "scaling": args.scaling_lr,
            "rotation": args.rotation_lr, "opacity": args.opacity_lr}


def _s3_project(net, net_vars, splats: G.GaussianParams, bind: AG.AvatarBinding,
                mesh_f: torch.Tensor, item: S3Item, b: int, *, sh_degree: int,
                vis_raster_hw=(256, 256)):
    """Item ``b``: net → shadow textures → world-space texel splats. Returns
    (bundle, visibility (G,), local_xyz (G,3))."""
    mesh_v = item.mesh_v[b]
    frames = MG.compute_face_frames(mesh_v, mesh_f)
    rows = MG.gather_frame_rows(frames, bind.binding, mesh_v, mesh_f)
    with log.span("unet"):
        shadow_tex = functional_call(net, net_vars, (
            item.ambient[b], item.normal[b], item.world_view[b], item.campos[b], bind, mesh_v,
            mesh_f, frames), {"rows": rows})
    local_xyz, shs = apply_shadow(bind, splats, shadow_tex, sh_degree)
    anchor = AG.barycentric_3d(bind, mesh_v, mesh_f, rows=rows)
    bundle = SplatBundle(
        means3d=AG.avatar_world_xyz(local_xyz, bind, frames, anchor, rows=rows),
        opacity=AG.texel_opacity(bind, splats),
        scales=MG.world_scaling(splats, bind.binding, frames, rows=rows),
        rotations=MG.world_rotation(splats, bind.binding, frames, rows=rows),
        shs=shs, active_sh_degree=sh_degree)
    if item.vis is not None:
        vis = item.vis[b]
    else:
        with torch.no_grad():
            vis = AG.get_visible_mask_depth(
                bind, mesh_v, mesh_f, item.world_view[b], item.full_proj[b],
                image_width=vis_raster_hw[1], image_height=vis_raster_hw[0], rows=rows)
    return bundle, vis, local_xyz


def _s3_forward_batch(net, net_vars, splats, bind, mesh_f, item: S3Item, *, sh_degree: int,
                      raster_cfg: RasterConfig = RasterConfig(), vis_raster_hw=(256, 256)):
    """Every item rendered on a zero background, its own background blended
    as ``img + bg·(1 − α)``. Returns (rendered (B,3,H,W), local_xyz (B,G,3))."""
    net_vars = _cast_net_vars(net, net_vars)
    rendered, local = [], []
    zero_bg = torch.zeros(3, device=item.image.device)
    for b in range(item.image.shape[0]):
        with log.span("texels"):
            bundle, vis, local_xyz = _s3_project(net, net_vars, splats, bind, mesh_f, item, b,
                                                 sh_degree=sh_degree,
                                                 vis_raster_hw=vis_raster_hw)
        cams = BatchedCameras(world_view=item.world_view[b:b + 1],
                              full_proj=item.full_proj[b:b + 1], campos=item.campos[b:b + 1],
                              tanfovx=(item.tanfovx[b],), tanfovy=(item.tanfovy[b],),
                              width=item.width, height=item.height)
        out = render_batch(cams, bundle, zero_bg, vis_mask=vis, config=raster_cfg)
        rendered.append(out["render"][0] + item.bg[b][:, None, None] * (1.0 - out["alpha"][0]))
        local.append(local_xyz)
    return torch.stack(rendered), torch.stack(local)


def _cast_net_vars(net, net_vars):
    """(params, buffers) with every float tensor cast to the net's
    ``act_dtype`` (the noise buffers too); unchanged for a float32 net."""
    if net.act_dtype == torch.float32:
        return net_vars
    return tuple({k: v.to(net.act_dtype) if v.is_floating_point() else v for k, v in d.items()}
                 for d in net_vars)


def _s3_losses(net, net_params, net_buffers, splats, bind, mesh_f, item: S3Item, args, *,
               sh_degree: int, raster_cfg: RasterConfig = RasterConfig(),
               vis_raster_hw=(256, 256)):
    """(total, loss dict) of one batch (``training/s3.py:_s3_losses``)."""
    rendered, local_xyz = _s3_forward_batch(
        net, (net_params, net_buffers), splats, bind, mesh_f, item, sh_degree=sh_degree,
        raster_cfg=raster_cfg, vis_raster_hw=vis_raster_hw)
    mask = item.mask if args.only_foreground_loss else None
    if bind.alive is not None:
        # dense layout: mean over the alive texels, as the compact layout's
        a = bind.alive.to(torch.float32)
        mean = lambda x: (x * a).sum() / torch.clamp(a.sum(), min=1.0) / (
            x.shape[0] if x.ndim == 2 else 1.0)
    else:
        mean = torch.mean
    with log.span("loss"):
        loss: Dict[str, torch.Tensor] = {
            "img": l1_loss(rendered, item.image, mask) * (1.0 - args.lambda_dssim),
            # the reference's quirk, kept: 1 - ssim·λ, not (1 - ssim)·λ
            "ssim": 1.0 - ssim(rendered, item.image, mask) * args.lambda_dssim,
            # hinges (s3_appearance.py:134-137): local xyz per item, scale and
            # opacity over the splats
            "xyz": mean(torch.relu(safe_norm(local_xyz, -1) - args.threshold_xyz))
            * args.lambda_xyz,
            "scale": mean(safe_norm(torch.relu(torch.exp(splats.scaling)
                                               - args.threshold_scale), 1))
            * args.lambda_scale,
            "opacity": mean(torch.relu(args.threshold_opacity
                                       - G.get_opacity(splats)).reshape(-1))
            * args.lambda_opacity,
        }
        return sum(loss.values()), loss


def _runs_as_graph(item: S3Item, group: Optional[Group]) -> bool:
    """Whether a step replays a graph: on the card, without a ``group`` (a
    captured collective is not shown to work) and with the items'
    visibility given (its depth test is not shown capturable)."""
    return group is None and item.vis is not None and item.image.is_cuda


def make_s3_step(net: torch.nn.Module, args, *, sh_degree: int,
                 raster_cfg: RasterConfig = RasterConfig(), vis_raster_hw=(256, 256),
                 train_gaussians: bool = True, group: Optional[Group] = None):
    """``step(state, bind, mesh_f, item) -> (state, loss_dict)``. With
    ``train_gaussians=False`` (epoch-1 pre-training, s3_appearance.py:110-113)
    only the net is updated and the splats' Adam state does not step. With a
    ``group``, ``item`` is this rank's shard and the new state is the same on
    every rank. ``step.graph_call`` gives what the step hands the graph,
    ``step.eager`` the step never captured (see the module doc)."""
    graphs = graph.Graphs("s3_graph")

    def step(state: S3State, bind: AG.AvatarBinding, mesh_f: torch.Tensor, item: S3Item):
        if not _runs_as_graph(item, group):
            return eager(state, bind, mesh_f, item)
        with log.span("step"):
            return _finish(state, graphs(*graph_call(state, bind, mesh_f, item)))

    def graph_call(state: S3State, bind: AG.AvatarBinding, mesh_f: torch.Tensor, item: S3Item):
        """``graphs``' arguments: the device part, its arguments with the
        per-step numbers as floats, and what it closes over."""
        bcs = lambda adam: tuple(map(float, bias_corrections(adam.step + 1)))
        return (_device, _device_args(state, bind, mesh_f, item, bcs),
                (net.act_dtype, train_gaussians))

    def eager(state: S3State, bind: AG.AvatarBinding, mesh_f: torch.Tensor, item: S3Item):
        with log.span("step"):
            bcs = lambda adam: to_device(bias_corrections(adam.step + 1), state.splats.xyz.device)
            return _finish(state, _device(*_device_args(state, bind, mesh_f, item, bcs)))

    def _device_args(state: S3State, bind: AG.AvatarBinding, mesh_f: torch.Tensor,
                     item: S3Item, bcs) -> tuple:
        """What the device part reads of the state and the step: ``bcs``
        gives an Adam's bias corrections of its next step. Without
        ``train_gaussians`` it reads no splat moment."""
        splat_moments = splat_bcs = None
        if train_gaussians:
            splat_moments = (state.splat_adam.mu, state.splat_adam.nu)
            splat_bcs = bcs(state.splat_adam)
        return (state.net_params, state.net_buffers, (state.net_adam.mu, state.net_adam.nu),
                state.splats, splat_moments, bind, mesh_f, item, bcs(state.net_adam), splat_bcs)

    def _device(net_params: Dict[str, torch.Tensor], net_buffers: Dict[str, torch.Tensor],
                net_moments: tuple, splats: G.GaussianParams, splat_moments: Optional[tuple],
                bind: AG.AvatarBinding, mesh_f: torch.Tensor, item: S3Item, net_bcs, splat_bcs):
        """One Adam step of the net and, with ``train_gaussians``, of the
        splats, from their moments. Returns (new net parameters, their
        moments, new splats and their moments or None, loss_dict)."""
        params = {k: v.detach().requires_grad_(True) for k, v in net_params.items()}
        leaf_splats = G.GaussianParams(**{k: getattr(splats, k).detach().requires_grad_(
            train_gaussians) for k in G.PARAM_NAMES})
        total, loss = _s3_losses(net, params, net_buffers, leaf_splats, bind, mesh_f, item,
                                 args, sh_degree=sh_degree, raster_cfg=raster_cfg,
                                 vis_raster_hw=vis_raster_hw)
        leaves = list(params.values())
        if train_gaussians:
            leaves += [getattr(leaf_splats, k) for k in G.PARAM_NAMES]
        with log.span("backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads, loss = pmean((list(grads), {k: v.detach() for k, v in loss.items()}), group)
        new_splats = new_splat_moments = None
        with torch.no_grad(), log.span("adam"):
            # the step counts stay on the host: the bias corrections carry them
            g_net = dict(zip(params, grads[:len(params)]))
            new_net, net_adam = tree_adam_step(net_params, g_net, TreeAdam(0, *net_moments),
                                               args.lr_init, bcs=net_bcs)
            if train_gaussians:
                g_spl = G.GaussianParams(**dict(zip(G.PARAM_NAMES, grads[len(params):])))
                new_splats, spl_adam = G.adam_step(splats, g_spl, G.AdamState(0, *splat_moments),
                                                   splat_lrs(args), bcs=splat_bcs)
                new_splat_moments = (spl_adam.mu, spl_adam.nu)
        return new_net, (net_adam.mu, net_adam.nu), new_splats, new_splat_moments, loss

    def _finish(state: S3State, out) -> tuple:
        """(state, loss_dict) from the device part's outputs; the step
        counters and ``iteration`` advance here, as host ints."""
        net_params, net_moments, splats, splat_moments, loss = out
        kw = dict(net_params=net_params, net_adam=TreeAdam(state.net_adam.step + 1, *net_moments))
        if train_gaussians:
            kw.update(splats=splats,
                      splat_adam=G.AdamState(state.splat_adam.step + 1, *splat_moments))
        return state.replace(iteration=state.iteration + 1, **kw), loss

    step.eager, step.graph_call = eager, graph_call
    return step


def make_s3_eval(net: torch.nn.Module, *, sh_degree: int,
                 raster_cfg: RasterConfig = RasterConfig(), vis_raster_hw=(256, 256)):
    """``eval(state, bind, mesh_f, item) -> (B,3,H,W)`` renders: the forward
    without losses or optimiser, for PSNR/SSIM on the llffhold split."""

    @torch.no_grad()
    def eval_fn(state: S3State, bind: AG.AvatarBinding, mesh_f: torch.Tensor, item: S3Item):
        rendered, _ = _s3_forward_batch(
            net, (state.net_params, state.net_buffers), state.splats, bind, mesh_f, item,
            sh_degree=sh_degree, raster_cfg=raster_cfg, vis_raster_hw=vis_raster_hw)
        return rendered

    return eval_fn
