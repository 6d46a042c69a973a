"""Stage-3 checkpoints of the JAX package, read and written from torch.

The JAX package saves ``<model>/ckpt/net.pkl``: a pickled dict of numpy trees
(``epoch``, ``activate_sh_degree``, ``net_params`` and ``net_buffers`` in
Flax's names, and ``splats``, a pickled
``gaussian_garments_tpu.models.gaussian.GaussianParams``). Unpickling that
as-is would import jax, so ``load_s3_ckpt`` maps the class to the port's own
container. ``save_s3_ckpt`` writes the same layout, class path included, so
the JAX package reads what the port writes.

``avatar_net_state_from_jax`` / ``avatar_net_state_to_jax`` convert the
weights: a state_dict key of the port's AvatarNet is the Flax path joined
with dots. Orbax checkpoints (``net.orbax``) are not read yet.

``s2_state_from_jax`` / ``s2_state_to_jax`` convert a stage-2 training state
(splats, statistics, both Adam states, binding, mesh) to and from the JAX
package's ``S2State`` fields as numpy arrays.
"""
from __future__ import annotations

import io
import os
import pickle
import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch.models.gaussian import PARAM_NAMES, GaussianParams

JAX_PARAMS_CLASS = ("gaussian_garments_tpu.models.gaussian", "GaussianParams")
_BUFFER_KEY = re.compile(r"(^|\.)noise_\d+$")


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == JAX_PARAMS_CLASS:
            return GaussianParams
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "orbax"):
            raise pickle.UnpicklingError(
                f"checkpoint holds a {module}.{name} object; only numpy trees are supported")
        return super().find_class(module, name)


class _JaxCheckpointPickler(pickle._Pickler):
    """Writes the port's GaussianParams under the JAX class path."""

    def save_global(self, obj, name=None):
        if obj is GaussianParams:
            self.save(JAX_PARAMS_CLASS[0])
            self.save(JAX_PARAMS_CLASS[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def load_s3_ckpt(model_path, name: str = "ckpt") -> Dict:
    """The checkpoint dict (epoch, net_params, net_buffers, splats) with numpy
    leaves and ``splats`` as the port's GaussianParams (numpy fields)."""
    path = Path(model_path) / name
    if (path / "net.orbax").exists():
        raise NotImplementedError(
            f"{path / 'net.orbax'} is an orbax checkpoint; the torch port reads only "
            "net.pkl (see ROADMAP.md). Re-save the stage-3 run with backend='pickle'.")
    with open(path / "net.pkl", "rb") as f:
        net = _JaxCheckpointUnpickler(f).load()
    net.setdefault("net_buffers", {})
    return net


def save_s3_ckpt(model_path, *, net_params: dict, net_buffers: dict,
                 splats: GaussianParams, epoch: int = 0, active_sh_degree: int = 3,
                 name: str = "ckpt") -> None:
    """Write ``net.pkl`` + ``info.txt`` in the JAX package's layout."""
    path = Path(model_path) / name
    os.makedirs(path, exist_ok=True)
    with open(path / "info.txt", "w") as f:
        f.write(f"Epoch {epoch}\n")
    to_np = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    net = {
        "epoch": epoch,
        "activate_sh_degree": active_sh_degree,
        "net_params": net_params,
        "net_buffers": net_buffers,
        "splats": GaussianParams(**{k: to_np(getattr(splats, k)) for k in PARAM_NAMES}),
    }
    buf = io.BytesIO()
    _JaxCheckpointPickler(buf, protocol=4).dump(net)
    (path / "net.pkl").write_bytes(buf.getvalue())


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def avatar_net_state_from_jax(net_params: dict, net_buffers: dict) -> Dict[str, torch.Tensor]:
    """Flax ``params`` + ``buffers`` trees (numpy) -> AvatarNet state_dict."""
    flat = _flatten(net_params)
    flat.update(_flatten(net_buffers))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()}


def avatar_net_state_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """AvatarNet state_dict -> (Flax ``params`` tree, ``buffers`` tree), numpy."""
    params, buffers = {}, {}
    for k, v in state_dict.items():
        (buffers if _BUFFER_KEY.search(k) else params)[k] = v.detach().cpu().numpy()
    return _unflatten(params), _unflatten(buffers)


# ---------------------------------------------------------------------------
# stage-2 state
# ---------------------------------------------------------------------------

AUX_NAMES = ("alive", "max_radii2d", "xyz_gradient_accum", "denom")
MESH_ARRAYS = ("v", "vt", "f", "v_mass", "f_area", "dm_inv", "f_connectivity",
               "f_connectivity_edges", "edges", "virtual_edge", "ve_len", "nn_points",
               "nn_normals", "tar_v")


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def s2_state_to_jax(state) -> dict:
    """The port's ``training.s2.S2State`` as the JAX package's ``S2State``
    fields in nested dicts of numpy arrays (int32 indices, as the JAX package
    keeps them): params, aux, splat_adam {step, mu, nu}, binding, mesh (with
    ``has_body``), vert_adam {step, mu, nu}, iteration."""
    idx = lambda x: _np(x).astype(np.int32)
    fields = lambda obj, names: {k: _np(getattr(obj, k)) for k in names}
    mesh = {k: _np(getattr(state.mesh, k)) for k in MESH_ARRAYS}
    for k in ("f", "f_connectivity", "f_connectivity_edges", "edges", "virtual_edge"):
        mesh[k] = mesh[k].astype(np.int32)
    mesh["has_body"] = bool(state.mesh.has_body)
    adam = state.splat_adam
    return {
        "params": fields(state.params, PARAM_NAMES),
        "aux": fields(state.aux, AUX_NAMES),
        "splat_adam": {"step": np.int32(adam.step), "mu": fields(adam.mu, PARAM_NAMES),
                       "nu": fields(adam.nu, PARAM_NAMES)},
        "binding": idx(state.binding),
        "mesh": mesh,
        "vert_adam": {"step": np.int32(state.vert_adam.step), "mu": _np(state.vert_adam.mu),
                      "nu": _np(state.vert_adam.nu)},
        "iteration": np.int32(state.iteration),
    }


def s2_state_from_jax(tree, device=None):
    """A JAX ``S2State`` (its numpy leaves, as objects with the JAX field
    names or as the dicts of ``s2_state_to_jax``) -> the port's S2State on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.models.adam import TensorAdam
    from gaussian_garments_tpu_torch.models.gaussian import AdamState, GaussianAux
    from gaussian_garments_tpu_torch.models.mesh_model import MeshState
    from gaussian_garments_tpu_torch.training.s2 import S2State

    device = resolve_device(device)

    def t(x):
        a = np.asarray(x)
        dtype = torch.int64 if a.dtype.kind in "iu" else None
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    group = lambda g, names: {k: t(_field(g, k)) for k in names}
    adam, vadam, mesh = (_field(tree, k) for k in ("splat_adam", "vert_adam", "mesh"))
    mesh_arrays = {k: (t(_field(mesh, k)) if _field(mesh, k) is not None else None)
                   for k in MESH_ARRAYS}
    return S2State(
        params=GaussianParams(**group(_field(tree, "params"), PARAM_NAMES)),
        aux=GaussianAux(**group(_field(tree, "aux"), AUX_NAMES)),
        splat_adam=AdamState(step=int(_field(adam, "step")),
                             mu=GaussianParams(**group(_field(adam, "mu"), PARAM_NAMES)),
                             nu=GaussianParams(**group(_field(adam, "nu"), PARAM_NAMES))),
        binding=t(_field(tree, "binding")),
        mesh=MeshState(**mesh_arrays, has_body=bool(_field(mesh, "has_body"))),
        vert_adam=TensorAdam(int(_field(vadam, "step")), t(_field(vadam, "mu")),
                             t(_field(vadam, "nu"))),
        iteration=int(_field(tree, "iteration")))
