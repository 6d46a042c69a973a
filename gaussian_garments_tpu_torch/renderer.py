"""Render API: ``render``, ``render_batch`` and ``doll_render``.

Port of ``gaussian_garments_tpu/renderer.py``. The caller passes a
``SplatBundle`` (world-space splat tensors + SH degree) and gets the
reference's output dict ``{render, visibility_filter, radii, 3dposition,
depth, alpha, raster_aux}``. ``render_batch`` renders a ``BatchedCameras``
as a loop over its cameras and stacks the results. The JAX package's
``pair_budget`` and ``count_pairs_batch`` answer the TPU's static shapes; the
port allocates pairs exactly and has neither (``n_overflow`` is always 0).

``RasterConfig`` keeps only the knobs that mean something here: the tile clip
window and the backend. ``backend="auto"`` composites with the CUDA kernel
for CUDA tensors and with its plain torch version for CPU tensors;
``backend="reference"`` is the exact per-pixel oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import rasterize_reference
from gaussian_garments_tpu_torch.ops.tiles import rasterize_tiles


@dataclasses.dataclass(frozen=True)
class SplatBundle:
    """World-space splat tensors ready for rasterization."""

    means3d: torch.Tensor                         # (N,3)
    opacity: torch.Tensor                         # (N,1) activated
    scales: Optional[torch.Tensor] = None         # (N,3) activated
    rotations: Optional[torch.Tensor] = None      # (N,4) normalized
    cov3d_precomp: Optional[torch.Tensor] = None  # (N,6)
    shs: Optional[torch.Tensor] = None            # (N,K,3)
    colors_precomp: Optional[torch.Tensor] = None  # (N,3)
    active_sh_degree: int = 0

    def replace(self, **kw) -> "SplatBundle":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """max_tiles_side: a splat's tile rect is clipped to this many tiles per
    side, anchored at its top-left. backend: "auto" or "reference"."""

    max_tiles_side: int = 6
    backend: str = "auto"


def _rasterize(proj, *, image_height, image_width, bg, config: RasterConfig):
    if config.backend == "reference":
        image, depth, alpha = rasterize_reference(
            proj, image_height=image_height, image_width=image_width, bg=bg)
        zero = torch.zeros((), dtype=torch.int32, device=bg.device)
        return image, depth, alpha, {"n_clipped": zero, "n_overflow": zero}
    if config.backend != "auto":
        raise ValueError(f"unknown backend {config.backend!r}")
    return rasterize_tiles(proj, image_height=image_height, image_width=image_width,
                           bg=bg, max_tiles_side=config.max_tiles_side)


def _project(bundle: SplatBundle, world_view, full_proj, campos, *, width, height, tanfovx,
             tanfovy, scaling_modifier, vis_mask, screen_offset):
    opac = bundle.opacity.reshape(-1)
    if vis_mask is not None:
        opac = opac * vis_mask.to(opac.dtype)
    return project_gaussians(
        bundle.means3d, world_view, full_proj, campos, image_width=width,
        image_height=height, tanfovx=tanfovx, tanfovy=tanfovy,
        scales=bundle.scales, rotations=bundle.rotations,
        cov3d_precomp=bundle.cov3d_precomp, shs=bundle.shs,
        colors_precomp=bundle.colors_precomp, opacities=opac,
        sh_degree=bundle.active_sh_degree, scaling_modifier=scaling_modifier,
        screen_offset=screen_offset)


def project(camera, bundle: SplatBundle, *, scaling_modifier: float = 1.0,
            vis_mask: Optional[torch.Tensor] = None,
            screen_offset: Optional[torch.Tensor] = None):
    """The bundle's splats projected into ``camera`` (SH evaluated at the
    bundle's degree, ``vis_mask`` folded into opacity)."""
    return _project(bundle, camera.world_view_transform, camera.full_proj_transform,
                    camera.camera_center, width=camera.image_width,
                    height=camera.image_height, tanfovx=camera.tanfovx,
                    tanfovy=camera.tanfovy, scaling_modifier=scaling_modifier,
                    vis_mask=vis_mask, screen_offset=screen_offset)


def render(camera, bundle: SplatBundle, bg_color: torch.Tensor, *,
           scaling_modifier: float = 1.0, vis_mask: Optional[torch.Tensor] = None,
           screen_offset: Optional[torch.Tensor] = None,
           config: RasterConfig = RasterConfig()):
    """Splat render of one camera (reference ``render``,
    ``gaussian_renderer/__init__.py:36-122``)."""
    proj = project(camera, bundle, scaling_modifier=scaling_modifier, vis_mask=vis_mask,
                   screen_offset=screen_offset)
    image, depth, alpha, aux = _rasterize(
        proj, image_height=camera.image_height, image_width=camera.image_width,
        bg=bg_color, config=config)
    return {
        "render": image,
        "visibility_filter": proj.radii > 0,
        "radii": proj.radii,
        "3dposition": bundle.means3d,
        "depth": depth,
        "alpha": alpha,
        "raster_aux": aux,
    }


@dataclasses.dataclass(frozen=True)
class BatchedCameras:
    """A stacked batch of cameras sharing width and height."""

    world_view: torch.Tensor              # (B,4,4) transposed world->view
    full_proj: torch.Tensor               # (B,4,4)
    campos: torch.Tensor                  # (B,3)
    tanfovx: Tuple[float, ...]
    tanfovy: Tuple[float, ...]
    image: Optional[torch.Tensor] = None  # (B,3,H,W)
    mask: Optional[torch.Tensor] = None   # (B,1,H,W)
    width: int = 0
    height: int = 0

    @classmethod
    def from_cameras(cls, cameras, include_images: bool = True) -> "BatchedCameras":
        c0 = cameras[0]
        has_img = include_images and c0.original_image is not None
        has_mask = include_images and c0.gt_alpha_mask is not None
        return cls(
            world_view=torch.stack([c.world_view_transform for c in cameras]),
            full_proj=torch.stack([c.full_proj_transform for c in cameras]),
            campos=torch.stack([c.camera_center for c in cameras]),
            tanfovx=tuple(c.tanfovx for c in cameras),
            tanfovy=tuple(c.tanfovy for c in cameras),
            image=torch.stack([c.original_image for c in cameras]) if has_img else None,
            mask=torch.stack([c.gt_alpha_mask for c in cameras]) if has_mask else None,
            width=c0.image_width, height=c0.image_height)


def render_batch(cams: BatchedCameras, bundle: SplatBundle, bg_color: torch.Tensor, *,
                 scaling_modifier: float = 1.0, vis_mask: Optional[torch.Tensor] = None,
                 screen_offset: Optional[torch.Tensor] = None,
                 config: RasterConfig = RasterConfig()):
    """``render`` over a camera batch, one camera at a time. ``screen_offset``
    is (B,N,2). Returns the dict of ``render`` with a leading batch axis on
    render/depth/alpha/radii/visibility_filter and on raster_aux's counts."""
    outs = []
    for b in range(cams.world_view.shape[0]):
        proj = _project(bundle, cams.world_view[b], cams.full_proj[b], cams.campos[b],
                        width=cams.width, height=cams.height, tanfovx=cams.tanfovx[b],
                        tanfovy=cams.tanfovy[b], scaling_modifier=scaling_modifier,
                        vis_mask=vis_mask,
                        screen_offset=None if screen_offset is None else screen_offset[b])
        image, depth, alpha, aux = _rasterize(proj, image_height=cams.height,
                                              image_width=cams.width, bg=bg_color,
                                              config=config)
        outs.append((image, depth, alpha, proj.radii, aux))
    radii = torch.stack([o[3] for o in outs])
    return {
        "render": torch.stack([o[0] for o in outs]),
        "depth": torch.stack([o[1] for o in outs]),
        "alpha": torch.stack([o[2] for o in outs]),
        "radii": radii,
        "visibility_filter": radii > 0,
        "raster_aux": {k: torch.stack([o[4][k] for o in outs]) for k in outs[0][4]},
    }


def doll_render(camera, bundle: SplatBundle, bg_color, *, override_shs=None,
                scaling_modifier: float = 1.0, vis_mask=None,
                config: Optional[RasterConfig] = None):
    """Reference ``doll_render``: ``render`` with caller-supplied combined SH.
    Returns (image, depth, alpha)."""
    if override_shs is not None:
        bundle = bundle.replace(shs=override_shs)
    out = render(camera, bundle, bg_color, scaling_modifier=scaling_modifier,
                 vis_mask=vis_mask, config=config or RasterConfig())
    return out["render"], out["depth"], out["alpha"]
