"""Stage-3 checkpoints of the JAX package, read and written from torch.

The JAX package saves ``<model>/ckpt/net.pkl``: a pickled dict of numpy trees
(``epoch``, ``activate_sh_degree``, ``net_params`` and ``net_buffers`` in
Flax's names, and ``splats``, a pickled
``gaussian_garments_tpu.models.gaussian.GaussianParams``), ``optm.pkl``
(``net_adam`` and ``splat_adam``, pickled
``gaussian_garments_tpu.models.adam.TreeAdam``s, and ``iteration``) and
``info.txt``. Unpickling that as-is would import jax, so ``load_s3_ckpt``
maps both classes to the port's own containers. ``save_s3_ckpt`` writes the
same layout, class paths included, so the JAX package reads what the port
writes.

A save writes its files into a temporary directory beside ``<model>/ckpt``
and swaps that in as a whole, and it may run on a background thread
(``async_save``; ``wait_for_saves`` joins it): these are the two properties
of the JAX package's orbax backend, which the port's ``--ckpt_backend
orbax`` gives the pickle layout. An orbax checkpoint
(``net.orbax``) needs jax to read; ``load_s3_ckpt`` refuses it by name and
points to ``scripts/orbax_to_pickle.py``, which converts it where jax is.

``avatar_net_state_from_jax`` / ``avatar_net_state_to_jax`` convert the
weights: a state_dict key of the port's AvatarNet is the Flax path joined
with dots. ``flax_state_to_torch`` does the same for any port module named
after its Flax counterpart, transposing ``nn.Dense`` kernels and taking
``nn.Conv`` kernels from HWIO to OIHW (``AppearanceNet``, ``ConvUNet``;
the ``Discriminator``'s own weights are already in torch's layout).

``s2_state_from_jax`` / ``s2_state_to_jax`` convert a stage-2 training state
(splats, statistics, both Adam states, binding, mesh) to and from the JAX
package's ``S2State`` fields as numpy arrays; ``s3_state_from_jax`` /
``s3_state_to_jax`` do the same for stage 3's ``S3State``.
"""
from __future__ import annotations

import ctypes
import errno
import os
import pickle
import re
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch.models.adam import TreeAdam
from gaussian_garments_tpu_torch.models.gaussian import PARAM_NAMES, GaussianParams

JAX_PARAMS_CLASS = ("gaussian_garments_tpu.models.gaussian", "GaussianParams")
JAX_ADAM_CLASS = ("gaussian_garments_tpu.models.adam", "TreeAdam")
# the port's class for each JAX class path a checkpoint may pickle, and back
_FROM_JAX = {JAX_PARAMS_CLASS: GaussianParams, JAX_ADAM_CLASS: TreeAdam}
_TO_JAX = {GaussianParams: JAX_PARAMS_CLASS, TreeAdam: JAX_ADAM_CLASS}
_BUFFER_KEY = re.compile(r"(^|\.)noise_\d+$")


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _FROM_JAX:
            return _FROM_JAX[(module, name)]
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "orbax"):
            raise pickle.UnpicklingError(
                f"checkpoint holds a {module}.{name} object; only numpy trees are supported")
        return super().find_class(module, name)


class _JaxCheckpointPickler(pickle._Pickler):
    """Writes the port's GaussianParams and TreeAdam under the JAX class
    paths."""

    def save_global(self, obj, name=None):
        if obj in _TO_JAX:
            self.save(_TO_JAX[obj][0])
            self.save(_TO_JAX[obj][1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _load(path: Path):
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()


ORBAX_CONVERTER = "scripts/orbax_to_pickle.py"
_TMP_TAG = ".tmp-"
_OLD_TAG = ".old-"
_WRITERS: List[threading.Thread] = []
_ERRORS: List[BaseException] = []


def _orbax_committed(od: Path) -> bool:
    """Whether ``net.orbax`` holds a committed orbax checkpoint: a
    digit-named manager step directory (an uncommitted one carries a suffix)
    or the older single-directory layout's metadata file (JAX
    ``training/checkpoints.py:193-205``)."""
    if not od.is_dir():
        return False
    if any(p.is_dir() and p.name.isdigit() for p in od.iterdir()):
        return True
    return (od / "_CHECKPOINT_METADATA").exists()


def load_s3_ckpt(model_path, name: str = "ckpt") -> Dict:
    """The checkpoint dict (epoch, activate_sh_degree, net_params,
    net_buffers, splats and, when ``optm.pkl`` is there, net_adam, splat_adam
    and iteration) with numpy leaves, ``splats`` as the port's GaussianParams
    and the Adam states as the port's TreeAdam. A committed orbax checkpoint
    is refused by name: the JAX package would read it in preference to any
    ``net.pkl`` beside it, and reading orbax needs jax."""
    wait_for_saves()
    path = _recover(Path(model_path) / name)
    if _orbax_committed(path / "net.orbax"):
        raise NotImplementedError(
            f"{path / 'net.orbax'} is an orbax checkpoint, which the torch port cannot read "
            f"(it needs jax and orbax). Convert it where they are installed: python "
            f"{ORBAX_CONVERTER} {model_path} OUT_PATH, then resume with --ckpt_path OUT_PATH.")
    net = _load(path / "net.pkl")
    if (path / "optm.pkl").exists():
        net.update(_load(path / "optm.pkl"))
    net.setdefault("net_buffers", {})
    return net


def has_s3_ckpt(model_path, name: str = "ckpt") -> bool:
    """Whether ``<model_path>/<name>`` holds a committed checkpoint: a
    ``net.pkl``, or a committed orbax directory (which ``load_s3_ckpt``
    refuses by name). A writer killed before its first commit leaves only
    temporaries, or an empty ``net.orbax``, and that is no checkpoint."""
    path = _recover(Path(model_path) / name)
    return (path / "net.pkl").exists() or _orbax_committed(path / "net.orbax")


def _recover(path: Path) -> Path:
    """``path``; where a save without the atomic exchange was cut between its
    two renames, the previous checkpoint is moved back to it first."""
    old = sorted(path.parent.glob(f"{path.name}{_OLD_TAG}*"))
    if old and not path.exists():
        os.rename(old[-1], path)
    return path


def _exchange(a: Path, b: Path) -> bool:
    """Swap the names of two directories in one step (Linux ``renameat2``
    with ``RENAME_EXCHANGE``); False where the system or file system has no
    such call."""
    fn = getattr(ctypes.CDLL(None, use_errno=True), "renameat2", None)
    if fn is None:
        return False
    at_fdcwd, rename_exchange = -100, 2
    if fn(at_fdcwd, os.fsencode(a), at_fdcwd, os.fsencode(b), rename_exchange) == 0:
        return True
    err = ctypes.get_errno()
    if err in (errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP):
        return False
    raise OSError(err, os.strerror(err), str(b))


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_all(path: Path, files) -> None:
    """Commit ``files`` (name, object; text as-is) as the directory ``path``:
    each is pickled into a new temporary directory beside it and flushed to
    disk, and the directory then takes ``path``'s place in one step. A reader
    sees the previous checkpoint whole or this one whole, never a mix; a
    writer cut before the swap leaves the temporary, which the next save
    removes."""
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp = path.with_name(f"{path.name}{_TMP_TAG}{tag}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for fname, obj in files:
        with open(tmp / fname, "wb") as f:
            if isinstance(obj, str):
                f.write(obj.encode())
            else:
                _JaxCheckpointPickler(f, protocol=4).dump(obj)
            f.flush()
            os.fsync(f.fileno())
    _fsync_dir(tmp)
    if not path.exists():
        os.rename(tmp, path)
    elif _exchange(tmp, path):
        shutil.rmtree(tmp)
    else:
        old = path.with_name(f"{path.name}{_OLD_TAG}{tag}")
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    _fsync_dir(path.parent)


def _run_writer(path: Path, files) -> None:
    try:
        _write_all(path, files)
    except Exception as e:   # re-raised by wait_for_saves
        _ERRORS.append(e)


def wait_for_saves() -> None:
    """Block until every asynchronous save has committed; re-raise the first
    error of a background writer."""
    while _WRITERS:
        _WRITERS.pop(0).join()
    if _ERRORS:
        err = _ERRORS[0]
        _ERRORS.clear()
        raise RuntimeError("an asynchronous checkpoint save failed") from err


def save_s3_ckpt(model_path, *, net_params: dict, net_buffers: dict,
                 splats: GaussianParams, epoch: int = 0, active_sh_degree: int = 3,
                 name: str = "ckpt", net_adam: TreeAdam = None, splat_adam: TreeAdam = None,
                 iteration: int = None, async_save: bool = False) -> None:
    """Write ``net.pkl``, ``info.txt`` and, given the Adam states,
    ``optm.pkl`` in the JAX package's layout. ``net_params``/``net_buffers``
    and the Adam moments of the net are Flax-named numpy trees
    (``s3_state_to_jax``), which the caller must not change afterwards.

    The files are written into a temporary directory, which then replaces
    ``<model_path>/<name>`` as a whole (``_write_all``), so a writer killed
    mid-save leaves the previous checkpoint whole (its net beside its own
    Adam moments) and at most a temporary, which the next save removes. A
    save first waits for any earlier asynchronous one, so a same-epoch
    re-save lands after it. With
    ``async_save`` the pickling and the writes run on a background thread
    that overlaps the caller's next steps; ``wait_for_saves`` (and
    ``load_s3_ckpt``) block until it has committed (the properties of the
    JAX package's orbax backend, ``training/checkpoints.py:98-124``)."""
    wait_for_saves()
    path = _recover(Path(model_path) / name)
    path.parent.mkdir(parents=True, exist_ok=True)
    for stale in path.parent.glob(f"{name}{_TMP_TAG}*"):
        shutil.rmtree(stale)
    files = []
    if net_adam is not None:
        files.append(("optm.pkl", {"net_adam": net_adam, "splat_adam": splat_adam,
                                   "iteration": int(iteration)}))
    files.append(("info.txt", f"Epoch {epoch}\n"))
    files.append(("net.pkl", {
        "epoch": epoch, "activate_sh_degree": active_sh_degree, "net_params": net_params,
        "net_buffers": net_buffers,
        "splats": GaussianParams(**{k: _np(getattr(splats, k)) for k in PARAM_NAMES})}))
    if async_save:
        writer = threading.Thread(target=_run_writer, args=(path, files), daemon=False)
        writer.start()
        _WRITERS.append(writer)
    else:
        _write_all(path, files)


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


def flax_state_to_torch(params: dict, buffers: dict = None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``buffers``) trees (numpy) -> the state_dict of the
    port module named after them. A ``kernel`` leaf becomes ``weight``: an
    ``nn.Dense`` kernel (in, out) is transposed, an ``nn.Conv`` kernel goes
    from HWIO to OIHW. Every other leaf keeps its name and layout."""
    flat = _flatten(params)
    flat.update(_flatten(buffers or {}))
    out = {}
    for k, v in flat.items():
        v = np.array(v, np.float32)
        if k == "kernel" or k.endswith(".kernel"):
            k = k[:-len("kernel")] + "weight"
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def avatar_net_state_from_jax(net_params: dict, net_buffers: dict) -> Dict[str, torch.Tensor]:
    """Flax ``params`` + ``buffers`` trees (numpy) -> AvatarNet state_dict."""
    return flax_state_to_torch(net_params, net_buffers)


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


# ---------------------------------------------------------------------------
# stage-3 state
# ---------------------------------------------------------------------------

def s3_state_to_jax(state) -> dict:
    """The port's ``training.s3.S3State`` as the JAX package's ``S3State``
    fields, numpy leaves: net_params and net_buffers as Flax trees, splats a
    GaussianParams, net_adam and splat_adam TreeAdams (int32 step, moments in
    the shape of what they move), iteration. Pickled, the containers carry
    the JAX class paths."""
    params = {k: _np(v) for k, v in state.net_params.items()}
    buffers = {k: _np(v) for k, v in state.net_buffers.items()}
    splats = lambda p: GaussianParams(**{k: _np(getattr(p, k)) for k in PARAM_NAMES})
    tree = lambda d: _unflatten({k: _np(v) for k, v in d.items()})
    return {
        "net_params": _unflatten(params),
        "net_buffers": _unflatten(buffers),
        "splats": splats(state.splats),
        "net_adam": TreeAdam(np.int32(state.net_adam.step), tree(state.net_adam.mu),
                             tree(state.net_adam.nu)),
        "splat_adam": TreeAdam(np.int32(state.splat_adam.step), splats(state.splat_adam.mu),
                               splats(state.splat_adam.nu)),
        "iteration": np.int32(state.iteration),
    }


def s3_state_from_jax(tree, device=None):
    """A JAX ``S3State`` (numpy leaves, as an object with the JAX field names
    or as the dict of ``s3_state_to_jax``) -> the port's S3State on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.models.gaussian import AdamState
    from gaussian_garments_tpu_torch.training.s3 import S3State

    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    flat = lambda d: {k: t(v) for k, v in _flatten(d).items()}
    splats = lambda p: GaussianParams(**{k: t(_field(p, k)) for k in PARAM_NAMES})
    net_adam, splat_adam = _field(tree, "net_adam"), _field(tree, "splat_adam")
    return S3State(
        net_params=flat(_field(tree, "net_params")),
        net_buffers=flat(_field(tree, "net_buffers")),
        splats=splats(_field(tree, "splats")),
        net_adam=TreeAdam(int(_field(net_adam, "step")), flat(_field(net_adam, "mu")),
                          flat(_field(net_adam, "nu"))),
        splat_adam=AdamState(step=int(_field(splat_adam, "step")),
                             mu=splats(_field(splat_adam, "mu")),
                             nu=splats(_field(splat_adam, "nu"))),
        iteration=int(_field(tree, "iteration")))
