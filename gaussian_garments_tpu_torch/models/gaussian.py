"""Vanilla 3DGS parameter set, its activations, creation, Adam, host-side
densification edits and PLY I/O (port of
``gaussian_garments_tpu/models/gaussian.py``; reference
``scene/gaussian_model.py``).

Like the JAX package, the splats sit in a capacity-padded buffer with an
``alive`` mask, and structural edits are host-side numpy operations that
compact the alive rows, edit them (zeroing the Adam moments of new rows) and
re-pad. Dead rows render with opacity 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.models.adam import TreeAdam, tree_adam_step
from gaussian_garments_tpu_torch.utils.general import (get_expon_lr_func, inverse_sigmoid,
                                                       knn_numpy)
from gaussian_garments_tpu_torch.utils.quaternion import normalize as quat_normalize
from gaussian_garments_tpu_torch.utils.quaternion import quat_to_rotmat
from gaussian_garments_tpu_torch.utils.sh import rgb2sh

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
AUX_NAMES = ("alive", "max_radii2d", "xyz_gradient_accum", "denom")


@dataclasses.dataclass
class GaussianParams:
    """The six splat tensors. Field names match the JAX class, so a JAX
    checkpoint's pickled state loads into this container."""

    xyz: torch.Tensor            # (M, 3)
    features_dc: torch.Tensor    # (M, 1, 3)
    features_rest: torch.Tensor  # (M, R, 3), R = (max_sh_degree+1)² - 1
    scaling: torch.Tensor        # (M, 3) log-scale
    rotation: torch.Tensor       # (M, 4) wxyz (unnormalized)
    opacity: torch.Tensor        # (M, 1) logit

    def to(self, device) -> "GaussianParams":
        return GaussianParams(**{k: torch.as_tensor(getattr(self, k), dtype=torch.float32,
                                                     device=device) for k in PARAM_NAMES})

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GaussianAux:
    """Per-splat state that is not optimized (densification statistics)."""

    alive: torch.Tensor               # (M,) bool
    max_radii2d: torch.Tensor         # (M,)
    xyz_gradient_accum: torch.Tensor  # (M, 1)
    denom: torch.Tensor               # (M, 1)

    def replace(self, **kw) -> "GaussianAux":
        return dataclasses.replace(self, **kw)


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return quat_normalize(p.rotation)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_features(p: GaussianParams) -> torch.Tensor:
    """(M, K, 3) concatenated SH coefficients, DC first."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_covariance(p: GaussianParams, scaling_modifier: float = 1.0) -> torch.Tensor:
    """(M, 6) upper-triangular Σ = (R S)(R S)ᵀ (xx, xy, xz, yy, yz, zz)."""
    from gaussian_garments_tpu_torch.ops.projection import build_cov3d

    return build_cov3d(get_scaling(p), get_rotation(p), scaling_modifier)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _pad(a: np.ndarray, capacity: int) -> np.ndarray:
    return np.pad(a, [(0, capacity - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def _pad_param(name: str, a: np.ndarray, capacity: int) -> np.ndarray:
    """Capacity padding with gradient-safe fills: dead rotation rows are
    identity quaternions, since an all-zero quaternion's normalize has a 0/0
    gradient that would leak NaN into the shared face-frame gradients."""
    if name == "rotation" and a.shape[0] < capacity:
        fill = np.zeros((capacity - a.shape[0],) + a.shape[1:], a.dtype)
        fill[:, 0] = 1.0
        return np.concatenate([a, fill])
    return _pad(a, capacity)


def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in arrays.items()}


def _fresh_aux(n: int, capacity: int, device) -> GaussianAux:
    alive = np.zeros((capacity,), bool)
    alive[:n] = True
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return GaussianAux(alive=torch.as_tensor(alive, device=device), max_radii2d=z(capacity),
                       xyz_gradient_accum=z(capacity, 1), denom=z(capacity, 1))


def _padded_params(arrays: Dict[str, np.ndarray], capacity: int, device) -> GaussianParams:
    return GaussianParams(**_tensors(
        {k: _pad_param(k, np.asarray(arrays[k], np.float32), capacity) for k in PARAM_NAMES},
        device))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, max_sh_degree: int,
                    capacity: Optional[int] = None,
                    device=None) -> Tuple[GaussianParams, GaussianAux]:
    """Splats from a coloured point cloud (reference ``create_from_pcd``):
    DC SH from RGB, isotropic log-scale from the mean squared distance to the
    3 nearest neighbours, identity rotations, opacity 0.1."""
    device = resolve_device(device)
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    r = (max_sh_degree + 1) ** 2 - 1
    sq, _ = knn_numpy(np.asarray(points, np.float64), 3)
    dist2 = np.maximum(sq.mean(axis=1), 1e-7).astype(np.float32)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    arrays = {
        "xyz": np.asarray(points, np.float32),
        "features_dc": rgb2sh(np.asarray(colors, np.float32))[:, None, :],
        "features_rest": np.zeros((n, r, 3), np.float32),
        "scaling": np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1),
        "rotation": rots,
        "opacity": inverse_sigmoid(np.float32(0.1) * np.ones((n, 1), np.float32)),
    }
    return _padded_params(arrays, capacity, device), _fresh_aux(n, capacity, device)


# ---------------------------------------------------------------------------
# optimizer: per-tensor Adam with named learning-rate groups
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: int              # shared: the reference steps all groups together
    mu: GaussianParams
    nu: GaussianParams


def adam_init(params: GaussianParams) -> AdamState:
    zeros = lambda: GaussianParams(**{k: torch.zeros_like(getattr(params, k))
                                      for k in PARAM_NAMES})
    return AdamState(step=0, mu=zeros(), nu=zeros())


def adam_step(params: GaussianParams, grads: GaussianParams, state: AdamState,
              lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15, bcs=None) -> Tuple[GaussianParams, AdamState]:
    """One Adam step with a learning rate per field; ``torch.optim.Adam``
    (eps=1e-15) semantics with bias correction (reference training_setup).
    ``models.adam.tree_adam_step`` over the six fields, ``bcs`` as it takes
    it."""
    fields = lambda p: {k: getattr(p, k) for k in PARAM_NAMES}
    new_p, tree = tree_adam_step(fields(params), fields(grads),
                                 TreeAdam(state.step, fields(state.mu), fields(state.nu)),
                                 lrs, b1, b2, eps, bcs)
    return GaussianParams(**new_p), AdamState(tree.step, GaussianParams(**tree.mu),
                                              GaussianParams(**tree.nu))


def make_lr_schedules(opt, spatial_lr_scale: float):
    """The reference LR groups (training_setup :156-170): xyz is scheduled,
    the others constant. Returns a callable iteration → {field: lr}."""
    xyz_sched = get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)

    def lrs(iteration):
        return {"xyz": xyz_sched(iteration), "features_dc": opt.feature_lr,
                "features_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
                "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}

    return lrs


def add_densification_stats(aux: GaussianAux, screen_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianAux:
    """Accumulate ‖∂L/∂mean2D‖ of the visible splats and track the largest
    screen radius (reference ``add_densification_stats`` :410-412 and the
    max_radii2D update of s2_registration.py:314-315)."""
    visible = radii > 0
    gnorm = torch.linalg.norm(screen_grad[:, :2], dim=-1, keepdim=True)
    return aux.replace(
        xyz_gradient_accum=aux.xyz_gradient_accum + torch.where(visible[:, None], gnorm,
                                                                torch.zeros_like(gnorm)),
        denom=aux.denom + visible[:, None].to(torch.float32),
        max_radii2d=torch.maximum(aux.max_radii2d, torch.where(
            visible, radii.to(torch.float32), torch.zeros_like(aux.max_radii2d))))


# ---------------------------------------------------------------------------
# host-side structural edits
# ---------------------------------------------------------------------------

class _HostGaussians(NamedTuple):
    """Compacted (alive-only) numpy view used during structural edits."""

    params: Dict[str, np.ndarray]
    mu: Dict[str, np.ndarray]
    nu: Dict[str, np.ndarray]
    max_radii2d: np.ndarray
    grad_accum: np.ndarray
    denom: np.ndarray


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _compact(params: GaussianParams, aux: GaussianAux, adam: AdamState) -> _HostGaussians:
    alive = _np(aux.alive)
    take = lambda t: {k: _np(getattr(t, k))[alive] for k in PARAM_NAMES}
    return _HostGaussians(params=take(params), mu=take(adam.mu), nu=take(adam.nu),
                          max_radii2d=_np(aux.max_radii2d)[alive],
                          grad_accum=_np(aux.xyz_gradient_accum)[alive],
                          denom=_np(aux.denom)[alive])


def _repack(h: _HostGaussians, step: int, capacity: Optional[int] = None,
            device=None) -> Tuple[GaussianParams, GaussianAux, AdamState]:
    """Re-pad the compacted rows to ``capacity`` on ``device``: params with
    the safe fills, Adam moments with zeros, the alive mask set."""
    device = resolve_device(device)
    n = h.params["xyz"].shape[0]
    capacity = capacity if capacity and capacity >= n else n
    params = _padded_params(h.params, capacity, device)
    pack0 = lambda d: GaussianParams(**_tensors({k: _pad(v, capacity) for k, v in d.items()},
                                                device))
    aux = _fresh_aux(n, capacity, device)
    aux = aux.replace(
        max_radii2d=torch.as_tensor(_pad(h.max_radii2d, capacity), device=device),
        xyz_gradient_accum=torch.as_tensor(_pad(h.grad_accum, capacity), device=device),
        denom=torch.as_tensor(_pad(h.denom, capacity), device=device))
    return params, aux, AdamState(step=step, mu=pack0(h.mu), nu=pack0(h.nu))


def _cat(h: _HostGaussians, new: Dict[str, np.ndarray]) -> _HostGaussians:
    """densification_postfix: append rows with zeroed Adam moments and reset
    the statistics of every row (reference :359-376)."""
    params = {k: np.concatenate([h.params[k], new[k]]) for k in PARAM_NAMES}
    mu = {k: np.concatenate([h.mu[k], np.zeros_like(new[k])]) for k in PARAM_NAMES}
    nu = {k: np.concatenate([h.nu[k], np.zeros_like(new[k])]) for k in PARAM_NAMES}
    n = params["xyz"].shape[0]
    return _HostGaussians(params, mu, nu, max_radii2d=np.zeros((n,), np.float32),
                          grad_accum=np.zeros((n, 1), np.float32),
                          denom=np.zeros((n, 1), np.float32))


def _select(h: _HostGaussians, keep: np.ndarray) -> _HostGaussians:
    f = lambda d: {k: v[keep] for k, v in d.items()}
    return _HostGaussians(f(h.params), f(h.mu), f(h.nu), h.max_radii2d[keep],
                          h.grad_accum[keep], h.denom[keep])


def densify_and_prune(params: GaussianParams, aux: GaussianAux, adam: AdamState, *,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: Optional[float], percent_dense: float,
                      rng: Optional[np.random.RandomState] = None, grow_capacity: float = 1.5,
                      ) -> Tuple[GaussianParams, GaussianAux, AdamState, Dict[str, int]]:
    """The reference densify_and_prune (:379-408) of the plain model as a
    host-side edit. Split samples come from ``rng`` as in the JAX package,
    so one seed gives the same splats in both. Returns the rebuilt (params,
    aux, adam) on the params' device and the edit statistics; capacity is
    kept if the splats fit, else grown by ``grow_capacity``."""
    rng = rng or np.random.RandomState(0)
    device = params.xyz.device
    old_capacity = params.xyz.shape[0]
    h = _compact(params, aux, adam)

    grads = h.grad_accum / np.maximum(h.denom, 1e-12)
    grads[~np.isfinite(grads)] = 0.0
    scaling = np.exp(h.params["scaling"])
    max_scale = scaling.max(axis=1)

    # --- clone (small, under-reconstructed) ---
    clone_mask = (np.linalg.norm(grads, axis=-1) >= max_grad) & (max_scale <= percent_dense * extent)
    n_clone = int(clone_mask.sum())
    if n_clone:
        h = _cat(h, {k: h.params[k][clone_mask] for k in PARAM_NAMES})
        grads = np.concatenate([grads, np.zeros((n_clone, 1), np.float32)])
        scaling = np.exp(h.params["scaling"])
        max_scale = scaling.max(axis=1)

    # --- split (large, over-reconstructed); N=2 samples, prune originals ---
    split_mask = (grads[:, 0] >= max_grad) & (max_scale > percent_dense * extent)
    n_split = int(split_mask.sum())
    if n_split:
        N = 2
        stds = np.repeat(scaling[split_mask], N, axis=0)
        samples = rng.normal(0.0, 1.0, stds.shape).astype(np.float32) * stds
        rots = quat_to_rotmat(torch.as_tensor(
            np.tile(h.params["rotation"][split_mask], (N, 1)))).numpy()
        new_xyz = np.einsum("nij,nj->ni", rots, samples) + np.tile(h.params["xyz"][split_mask], (N, 1))
        new = {
            "xyz": new_xyz.astype(np.float32),
            "scaling": np.log(np.repeat(scaling[split_mask], N, axis=0) / (0.8 * N)).astype(np.float32),
            "rotation": np.tile(h.params["rotation"][split_mask], (N, 1)),
            "features_dc": np.tile(h.params["features_dc"][split_mask], (N, 1, 1)),
            "features_rest": np.tile(h.params["features_rest"][split_mask], (N, 1, 1)),
            "opacity": np.tile(h.params["opacity"][split_mask], (N, 1)),
        }
        n_before = h.params["xyz"].shape[0]
        h = _cat(h, new)
        keep = np.ones((h.params["xyz"].shape[0],), bool)
        keep[:n_before] = ~split_mask
        h = _select(h, keep)

    # --- prune ---
    prune = 1.0 / (1.0 + np.exp(-h.params["opacity"][:, 0])) < min_opacity
    if max_screen_size:
        prune |= h.max_radii2d > max_screen_size
        prune |= np.exp(h.params["scaling"]).max(axis=1) > 0.1 * extent
    n_prune = int(prune.sum())
    h = _select(h, ~prune)

    n = h.params["xyz"].shape[0]
    capacity = old_capacity if n <= old_capacity else int(np.ceil(n * grow_capacity))
    out = _repack(h, adam.step, capacity, device=device)
    stats = {"n_clone": n_clone, "n_split": n_split, "n_prune": n_prune, "n_alive": n,
             "capacity": capacity}
    return (*out, stats)


def reset_opacity(params: GaussianParams, adam: AdamState) -> Tuple[GaussianParams, AdamState]:
    """opacity ← min(opacity, 0.01) with zeroed Adam moments for the opacity
    tensor (reference reset_opacity :261-264)."""
    new_op = inverse_sigmoid(torch.clamp(get_opacity(params), max=0.01))
    return params.replace(opacity=new_op), adam._replace(
        mu=adam.mu.replace(opacity=torch.zeros_like(new_op)),
        nu=adam.nu.replace(opacity=torch.zeros_like(new_op)))


# ---------------------------------------------------------------------------
# PLY (reference save_ply/load_ply :193-259, the same attribute layout)
# ---------------------------------------------------------------------------

def save_ply(path, params: GaussianParams, alive=None) -> None:
    from gaussian_garments_tpu_torch.utils.io import write_ply

    sel = _np(alive) if alive is not None else slice(None)
    p = {k: _np(getattr(params, k))[sel] for k in PARAM_NAMES}
    n = p["xyz"].shape[0]
    # torch layout: features (N, K, 3) -> transpose(1, 2) -> flatten => channel-major
    f_dc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    f_rest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    cols = {a: p["xyz"][:, i].astype(np.float32) for i, a in enumerate("xyz")}
    cols.update({a: np.zeros((n,), np.float32) for a in ("nx", "ny", "nz")})
    cols.update({f"f_dc_{i}": f_dc[:, i].astype(np.float32) for i in range(f_dc.shape[1])})
    cols.update({f"f_rest_{i}": f_rest[:, i].astype(np.float32) for i in range(f_rest.shape[1])})
    cols["opacity"] = p["opacity"][:, 0].astype(np.float32)
    cols.update({f"scale_{i}": p["scaling"][:, i].astype(np.float32) for i in range(3)})
    cols.update({f"rot_{i}": p["rotation"][:, i].astype(np.float32) for i in range(4)})
    write_ply(path, cols)


def load_ply(path, max_sh_degree: int, capacity: Optional[int] = None,
             device=None) -> Tuple[GaussianParams, GaussianAux]:
    from gaussian_garments_tpu_torch.utils.io import read_ply

    device = resolve_device(device)
    v = read_ply(path)
    n = len(v["x"])
    numbered = lambda prefix: sorted([k for k in v if k.startswith(prefix)],
                                     key=lambda s: int(s.split("_")[-1]))
    extra = numbered("f_rest_")
    r = (max_sh_degree + 1) ** 2 - 1
    if len(extra) != 3 * r:
        raise ValueError(f"PLY has {len(extra)} f_rest coefficients, expected {3 * r}")
    f_rest = np.stack([v[k] for k in extra], axis=1).reshape(n, 3, r) if r else \
        np.zeros((n, 3, 0), np.float32)
    arrays = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], axis=1),
        "features_dc": np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :],
        "features_rest": f_rest.transpose(0, 2, 1),
        "scaling": np.stack([v[k] for k in numbered("scale_")], axis=1),
        "rotation": np.stack([v[k] for k in numbered("rot_")], axis=1),
        "opacity": np.asarray(v["opacity"])[:, None],
    }
    capacity = capacity or n
    return _padded_params(arrays, capacity, device), _fresh_aux(n, capacity, device)
