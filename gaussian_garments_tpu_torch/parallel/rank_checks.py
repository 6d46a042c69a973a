"""The rank workers of the data-parallel checks, outside the library API.

``s2_steps`` and ``s3_steps`` run a step of each kind from a state saved in a
case file (``write_case``) on the rank's contiguous shard of the case's
batch, in whatever group the process is in (none: the whole batch), and
return the losses, the compared arrays, their differences from a reference
(``max_diffs``) and a digest of the final state (``digest``). The tests
(``tests/test_torch_data_parallel.py``) and ``chip_smoke.py`` run them under
``parallel.spawn`` and as one process, and hold the ranks against the
one-process step and the JAX package's ``shard_map`` step.
"""
from __future__ import annotations

import hashlib
import pickle
from typing import Dict, Sequence

import numpy as np
import torch

from gaussian_garments_tpu_torch.graft_entry import default_opt


def write_case(path, **case) -> str:
    """Pickle a case (numpy trees and plain values) for the rank workers."""
    with open(path, "wb") as f:
        pickle.dump(case, f, protocol=4)
    return str(path)


def _read_case(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def digest(tree) -> str:
    """sha256 of every array of a numpy tree, in order: equal digests mean
    states equal bit for bit."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)) or hasattr(x, "_fields"):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for k in x.__dataclass_fields__:
                walk(getattr(x, k))
        elif x is not None:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())

    walk(tree)
    return h.hexdigest()


def max_diffs(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """Per array, and for all the net's arrays together (``net``): the
    largest absolute difference (``abs``), its 99th percentile (``q99``), the
    most by which it exceeds 1e-4·|ref| (``excess``: an rtol-1e-4 comparison
    holds at atol ``excess``), the most by which it exceeds two float32
    roundings of the value, 2^-22·|ref| (``beyond_f32``), and the largest
    |ref| (``ref_max``)."""
    def summary(d, r):
        if d.size == 0:
            return {"abs": 0.0, "q99": 0.0, "excess": 0.0, "beyond_f32": 0.0, "ref_max": 0.0}
        return {"abs": float(d.max()), "q99": float(np.quantile(d, 0.99)),
                "excess": float((d - 1e-4 * np.abs(r)).max()),
                "beyond_f32": float((d - 2.0 ** -22 * np.abs(r)).max()),
                "ref_max": float(np.abs(r).max())}

    out, net_d, net_r = {}, [], []
    for k, r in ref.items():
        r = np.asarray(r, np.float64).ravel()
        d = np.abs(np.asarray(got[k], np.float64).ravel() - r)
        out[k] = summary(d, r)
        if k.startswith("net."):
            net_d.append(d)
            net_r.append(r)
    if net_d:
        out["net"] = summary(np.concatenate(net_d), np.concatenate(net_r))
    return out


def _launches() -> Dict[str, int]:
    from gaussian_garments_tpu_torch.ops import tiles

    return tiles.launches()


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def s2_compared(tree: dict) -> Dict[str, np.ndarray]:
    """The arrays of a stage-2 state that the checks compare: vertices, the
    splat parameters, the densification statistics."""
    out = {"v": tree["mesh"]["v"]}
    out.update({f"params.{k}": v for k, v in tree["params"].items()})
    out.update({f"aux.{k}": tree["aux"][k] for k in ("xyz_gradient_accum", "denom",
                                                       "max_radii2d")})
    return out


def s2_steps(case_path: str, modes: Sequence = (("template_p1", False), ("template_p2", True),
                                                ("seq", False)),
             n_steps: int = 1, device: str = "cpu", return_state: bool = True) -> dict:
    """Rank worker: ``n_steps`` of each stage-2 mode from the case's state on
    this rank's shard of its cameras. The case holds ``state`` (the tree of
    ``s2_state_to_jax``), ``cams`` (world_view, full_proj, campos, tanfovx,
    tanfovy, image, mask, width, height; numpy), ``bg``, ``xyz_lr``,
    ``vert_lr`` and, optionally, ``reference[mode]``: a compared-arrays tree
    after one step, which this worker diffs against. Returns per mode the
    losses and metrics of each step, the digest of the last state, the diffs
    and (``return_state``) the compared arrays after the first and last
    step."""
    from gaussian_garments_tpu_torch import parallel
    from gaussian_garments_tpu_torch.renderer import BatchedCameras
    from gaussian_garments_tpu_torch.training import s2 as S2
    from gaussian_garments_tpu_torch.training.checkpoints import (s2_state_from_jax,
                                                                  s2_state_to_jax)

    device, group = parallel.current(torch.device(device))
    case = _read_case(case_path)
    c = case["cams"]
    sh = lambda k: torch.as_tensor(np.ascontiguousarray(parallel.shard(c[k], group)),
                                   device=device)
    cams = BatchedCameras(world_view=sh("world_view"), full_proj=sh("full_proj"),
                          campos=sh("campos"), tanfovx=tuple(parallel.shard(c["tanfovx"], group)),
                          tanfovy=tuple(parallel.shard(c["tanfovy"], group)), image=sh("image"),
                          mask=sh("mask"), width=int(c["width"]), height=int(c["height"]))
    bg = torch.as_tensor(np.asarray(case["bg"], np.float32), device=device)
    opt = default_opt(**case.get("opt", {}))
    out, before = {}, _launches()
    for mode, use_body in modes:
        state = s2_state_from_jax(case["state"], device=device)
        step = S2.make_s2_step(opt, mode=mode, use_body=use_body, group=group)
        res = {"losses": [], "metrics": [], "states": []}
        for i in range(n_steps):
            state, loss, metrics = step(state, cams, bg, case["xyz_lr"], case["vert_lr"])
            res["losses"].append({k: float(v) for k, v in loss.items()})
            res["metrics"].append({k: float(v) for k, v in metrics.items()})
            if i in (0, n_steps - 1):
                tree = s2_compared(s2_state_to_jax(state))
                if i == 0 and mode in case.get("reference", {}):
                    res["diffs"] = max_diffs(tree, case["reference"][mode])
                if return_state:
                    res["states"].append(tree)
        res["digest"] = digest(s2_state_to_jax(state))
        out[mode] = res
    out["launches"] = _since(before)
    return out


def s3_compared(state) -> Dict[str, np.ndarray]:
    """The arrays of a stage-3 state that the checks compare: every net
    parameter, the splat parameters and the splats' first Adam moments (after
    one step, 0.1 × the step's reduced gradient)."""
    names = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    out = {f"net.{k}": v.detach().cpu().numpy() for k, v in state.net_params.items()}
    for tag, tree in (("splats", state.splats), ("splat_mu", state.splat_adam.mu)):
        out.update({f"{tag}.{k}": getattr(tree, k).detach().cpu().numpy() for k in names})
    return out


def s3_steps(case_path: str, kinds: Sequence[str] = ("pre", "full"), n_steps: int = 1,
             device: str = "cpu", return_state: bool = True) -> dict:
    """Rank worker: ``n_steps`` of each stage-3 step kind (``pre``: the net
    only; ``full``: net and splats) from the case's state on this rank's shard
    of its items. The case holds ``state`` (the tree of ``s3_state_to_jax``),
    ``item`` (the S3Item fields, numpy), ``uvs``, ``faces``, ``texture_size``,
    ``sh_degree``, ``vis_hw``, ``args`` (overrides of the optimisation
    flags, with ``lr_init``), optionally ``reference[kind]``: the compared
    arrays after one step, and ``cudnn_deterministic``: cuDNN restricted to
    deterministic algorithms (its default transposed convolution sums in a
    run-dependent order). A state without Adam moments starts them at
    zero. Returns what ``s2_steps`` returns and, in a group, the mean ms of
    the step's all-reduce (``allreduce_ms``: the coalesced ``pmean`` of
    a gradient tree of the net's and the splats' size, timed over
    ``allreduce_reps`` calls after the steps)."""
    from gaussian_garments_tpu_torch import parallel
    from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training import s3 as S3

    device, group = parallel.current(torch.device(device))
    case = _read_case(case_path)
    it = case["item"]
    sh = lambda k: torch.as_tensor(np.ascontiguousarray(parallel.shard(it[k], group)),
                                   device=device)
    item = S3.S3Item(**{k: sh(k) for k in ("image", "mask", "bg", "mesh_v", "ambient", "normal",
                                           "world_view", "full_proj", "campos", "vis")},
                     tanfovx=tuple(parallel.shard(it["tanfovx"], group)),
                     tanfovy=tuple(parallel.shard(it["tanfovy"], group)),
                     width=int(it["width"]), height=int(it["height"]))
    bind, _ = AG.build_binding(case["uvs"], case["faces"], case["texture_size"], device=device)
    mesh_f = torch.as_tensor(np.asarray(case["faces"], np.int64), device=device)
    net = AvatarNet(case["texture_size"], case["sh_degree"]).to(device)
    args = default_opt(**case["args"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = bool(case.get("cudnn_deterministic", deterministic))
    try:
        out = _s3_kinds(case, kinds, n_steps, device, group, net, bind, mesh_f, item, args,
                        return_state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def _s3_kinds(case, kinds, n_steps, device, group, net, bind, mesh_f, item, args,
              return_state) -> dict:
    from gaussian_garments_tpu_torch.training import s3 as S3
    from gaussian_garments_tpu_torch.training.checkpoints import s3_state_to_jax

    out, before = {}, _launches()
    for kind in kinds:
        state = _s3_state(case["state"], device)
        step = S3.make_s3_step(net, args, sh_degree=case["sh_degree"],
                               vis_raster_hw=tuple(case["vis_hw"]),
                               train_gaussians=kind == "full", group=group)
        res = {"losses": [], "states": []}
        for i in range(n_steps):
            state, loss = step(state, bind, mesh_f, item)
            res["losses"].append({k: float(v) for k, v in loss.items()})
            if i in (0, n_steps - 1):
                tree = s3_compared(state)
                if i == 0 and kind in case.get("reference", {}):
                    res["diffs"] = max_diffs(tree, case["reference"][kind])
                if return_state:
                    res["states"].append(tree)
        res["digest"] = digest(s3_state_to_jax(state))
        out[kind] = res
    out["launches"] = _since(before)
    if group is not None:
        out["allreduce_ms"] = _allreduce_ms(state, group, device, case.get("allreduce_reps", 5))
    return out


def _s3_state(tree, device):
    """The port's S3State of a tree, with zero Adam moments when it has none."""
    from gaussian_garments_tpu_torch.models import gaussian as G
    from gaussian_garments_tpu_torch.models.adam import TreeAdam
    from gaussian_garments_tpu_torch.training.checkpoints import s3_state_from_jax

    if "net_adam" not in tree:
        zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                           for k, v in t.items()}
        zs = G.GaussianParams(**{k: np.zeros_like(getattr(tree["splats"], k))
                                 for k in G.PARAM_NAMES})
        net = tree["net_params"]
        tree = dict(tree, net_adam=TreeAdam(0, zeros(net), zeros(net)),
                    splat_adam=TreeAdam(0, zs, zs), iteration=0)
    return s3_state_from_jax(tree, device=device)


def _allreduce_ms(state, group, device, reps: int) -> float:
    """Mean ms of the s3 step's all-reduce: the coalesced mean of a tree of
    the net's and the splats' shapes."""
    import time

    from gaussian_garments_tpu_torch import parallel

    tree = (list(state.net_params.values()),
            [getattr(state.splats, k) for k in ("xyz", "features_dc", "features_rest", "scaling",
                                                 "rotation", "opacity")])
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    parallel.pmean(tree, group)          # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        parallel.pmean(tree, group)
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps
