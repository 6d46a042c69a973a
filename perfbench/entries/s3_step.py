"""Stage-3 training steps: the program's ``training.s3.make_s3_step`` step
(the `full` kind: the net and the texel splats) on (frame, camera) items
drawn in a seeded shuffled order, and the plain reference that checks its
first three steps.

Inputs, made here from the seed and handed alike to the program and to the
reference: the posed garment of each frame, the cameras, each item's ground
truth, mask, background and texel visibility, the AO and normal bakes, the
net's weights and the texel splats. The program derives its own texel
binding from the UVs; the reference derives its own.

Correctness follows ``harness.training``: the step object the window drives
runs its first three steps in set-up on three different items, and the
reference follows them.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.gen import scene, weights
from perfbench.harness.training import TrainingEntry, reference_mode
from perfbench.reference import adam as ref_adam
from perfbench.reference import losses as ref_losses
from perfbench.reference import render as R
from perfbench.reference import texels as T
from perfbench.reference.styleunet import AvatarNet as RefNet, init_spec

SPLAT_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
CHECK_STEPS = 3


def _order(n_items: int, n: int, rng: np.random.Generator) -> list:
    out = []
    while len(out) < n:
        out.extend(rng.permutation(n_items).tolist())
    return out[:n]


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    g = cfg["garment"]
    rng = np.random.default_rng(int(seed))
    faces = scene.grid_faces(g["nx"], g["ny"])
    uvs = scene.garment_uvs(g["nx"], g["ny"])
    f_t = torch.as_tensor(faces, device=device)
    uv_t = torch.as_tensor(uvs, device=device)
    res, sh = cfg["texture_size"], cfg["sh_degree"]
    bind = T.binding(uvs, faces, res, device)
    rig = scene.rig(cfg["rig"], device)
    cam_ids = rng.choice(len(rig), traffic["cameras"], replace=False).tolist()
    motion = scene.garment_motion(g, rng)
    frames = [torch.as_tensor(scene.garment_pose(g, motion, traffic["frame_step"] * t),
                              device=device) for t in range(traffic["frames"])]
    bakes = [scene.bake(bind.face, bind.bc, bind.gs_u, bind.gs_v, res, v, f_t, cfg["body"],
                        cfg["bake"]["rays"]) for v in frames]
    items = []
    for fi, v in enumerate(frames):
        anchor = T.anchors(bind, v, f_t)
        for ci in cam_ids:
            cam = rig[ci]
            img, mask = scene.ground_truth(v, f_t, uv_t, cam, g["checker_squares"])
            vis = scene.visibility(anchor, v, f_t, cam, cfg["bake"]["vis_size"],
                                   cfg["bake"]["vis_rel_tol"])
            items.append(SimpleNamespace(frame=fi, cam=cam, image=img, mask=mask, vis=vis,
                                         bg=torch.as_tensor(rng.uniform(0, 1, 3),
                                                            dtype=torch.float32, device=device)))
    n_steps = traffic["max_steps"]
    return SimpleNamespace(faces=faces, uvs=uvs, f=f_t, bind=bind, frames=frames, bakes=bakes,
                  items=items, order=_order(len(items), n_steps, rng), res=res, sh=sh)


def net_spec(cfg: dict):
    with torch.device("meta"):
        return init_spec(RefNet(cfg["texture_size"], cfg["sh_degree"]))


class Entry(TrainingEntry):
    """One configuration under s3 traffic; see the module doc."""

    # ---- program side -------------------------------------------------------------
    def setup(self, fault=None):
        from gaussian_garments_tpu_torch import pin_full_f32
        from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
        from gaussian_garments_tpu_torch.models import gaussian as G
        from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
        from gaussian_garments_tpu_torch.training import s3 as S3

        cfg, dev = self.cfg, self.device
        pin_full_f32()
        t = time.perf_counter()
        inp = self.inp = make_inputs(cfg, self.traffic, self.seed, dev)
        t = self._mark("inputs", t)
        bind, _ = AG.build_binding(inp.uvs, inp.faces, inp.res, device=dev)
        if bind.binding.shape[0] != inp.bind.face.shape[0]:
            raise RuntimeError(f"program binds {bind.binding.shape[0]} texels, the reference "
                               f"{inp.bind.face.shape[0]}")
        with torch.device("meta"):
            net = AvatarNet(inp.res, inp.sh)
        net = net.to_empty(device=dev)
        net.load_state_dict(weights.draw(net_spec(cfg), self.seed, dev))
        spl = weights.texel_splats(bind.binding.shape[0], inp.sh, cfg["splats"], self.seed, dev)
        state = S3.init_state(net, G.GaussianParams(**spl))
        step = S3.make_s3_step(net, SimpleNamespace(**cfg["optim"]), sh_degree=inp.sh,
                               train_gaussians=True)
        if fault is not None:
            step = fault(step)
        items = [self._program_item(S3, it) for it in inp.items]
        self.prog = SimpleNamespace(step=step, bind=bind, items=items, state=state)
        t = self._mark("program", t)
        # the first steps: the reference follows the first CHECK_STEPS
        p0 = (dict(state.net_params), {k: getattr(state.splats, k) for k in SPLAT_KEYS})
        for i in range(CHECK_STEPS):
            self._run(i)
            if i == 0:
                st = self.prog.state
                self.readings["g1"] = {
                    **{k: m / (1 - ref_adam.B1) for k, m in st.net_adam.mu.items()},
                    **{k: getattr(st.splat_adam.mu, k) / (1 - ref_adam.B1) for k in SPLAT_KEYS}}
        st = self.prog.state
        self.readings["change"] = {
            **{k: st.net_params[k] - p0[0][k] for k in p0[0]},
            **{k: getattr(st.splats, k) - p0[1][k] for k in SPLAT_KEYS}}
        self.readings["loss"] = list(self.losses[:CHECK_STEPS])
        self.readings["groups"] = {"splats": list(SPLAT_KEYS)}
        for i in range(CHECK_STEPS, CHECK_STEPS + self.traffic["warmup_steps"]):
            self._run(i)
        self.n = CHECK_STEPS + self.traffic["warmup_steps"]
        self._mark("first_steps", t)

    def _program_item(self, S3, it):
        inp, v = self.inp, self.inp.frames[it.frame]
        amb, nrm = inp.bakes[it.frame]
        c = it.cam
        return S3.S3Item(image=it.image[None], mask=it.mask[None], bg=it.bg[None],
                         mesh_v=v[None], ambient=amb[None], normal=nrm[None],
                         world_view=c.world_view[None], full_proj=c.full_proj[None],
                         campos=c.campos[None], tanfovx=(c.tanfovx,), tanfovy=(c.tanfovy,),
                         vis=it.vis[None], width=c.width, height=c.height)

    def _run(self, i):
        p = self.prog
        p.state, loss = p.step(p.state, p.bind, self.inp.f, p.items[self.inp.order[i]])
        self.losses.append(float(sum(v for v in loss.values())))
        if i == 0:
            # the photometric terms of step 1, with the weights taken off: the SSIM
            # term is 1 - ssim·λ, whose constant would hide a change of the SSIM
            lam = self.cfg["optim"]["lambda_dssim"]
            self.readings["terms1"] = {"l1": float(loss["img"]) / (1.0 - lam),
                                       "ssim": (1.0 - float(loss["ssim"])) / lam}

    # ---- reference --------------------------------------------------------------------
    def _ref_model(self):
        cfg, dev, inp = self.cfg, self.device, self.inp
        with torch.device("meta"):
            net = RefNet(inp.res, inp.sh)
        net = net.to_empty(device=dev)
        net.load_state_dict(weights.draw(net_spec(cfg), self.seed, dev))
        spl = weights.texel_splats(inp.bind.face.shape[0], inp.sh, cfg["splats"], self.seed, dev)
        return net, spl

    def _ref_loss(self, net, spl, it, with_counts=False, tf32=False, terms=None):
        cfg, inp = self.cfg, self.inp
        o = cfg["optim"]
        b, f, v = inp.bind, inp.f, inp.frames[it.frame]
        amb, nrm = inp.bakes[it.frame]
        c = it.cam
        out = net(amb, nrm, c.world_view, T.local_viewdirs(b, v, f, c.campos), b.gs_u)
        rows = out.permute(1, 2, 0).reshape(inp.res * inp.res, -1)[b.gs_u * inp.res + b.gs_v]
        local = spl["xyz"] + rows[:, :3]
        shs = R.full_sh(spl["features_dc"], spl["features_rest"],
                        rows[:, 3:].reshape(rows.shape[0], -1, 3))
        means, scales, rots = T.texel_splats(b, v, f, local, spl["scaling"], spl["rotation"])
        opacity = torch.sigmoid(spl["opacity"])
        proj = R.project(means, scales, rots, shs, opacity[:, 0] * it.vis, c, inp.sh)
        pairs = R.tile_pairs(proj, c.width, c.height)
        if with_counts:
            return R.count_terms(proj, pairs, c.width, c.height)
        rgb, alpha = R.composite(proj, pairs, c.width, c.height, tf32)
        img = (rgb + it.bg[:, None, None] * (1.0 - alpha))[None]
        mask = it.mask[None] if o["only_foreground_loss"] else None
        lam = o["lambda_dssim"]
        l1 = ref_losses.l1(img, it.image[None], mask)
        ss = ref_losses.ssim(img, it.image[None], mask, tf32=tf32)
        if terms is not None:
            terms.update({"l1": float(l1.detach()), "ssim": float(ss.detach())})
        return (l1 * (1.0 - lam) + 1.0 - ss * lam
                + torch.relu(_safe_norm(local, -1) - o["threshold_xyz"]).mean() * o["lambda_xyz"]
                + _safe_norm(torch.relu(torch.exp(spl["scaling"]) - o["threshold_scale"]), 1).mean()
                * o["lambda_scale"]
                + torch.relu(o["threshold_opacity"] - opacity).mean() * o["lambda_opacity"])

    def reference(self, tf32: bool = False) -> dict:
        """The reference's losses, first gradient and change over the
        first CHECK_STEPS items, in float32; with ``tf32`` the control: TF32
        for cuDNN and matmuls, and the compositing's and SSIM's operands
        rounded to TF32."""
        with reference_mode(tf32, self.device):
            net, spl = self._ref_model()
            params = {**dict(net.named_parameters()), **spl}
            for p in params.values():
                p.requires_grad_(True)
            p0 = {k: p.detach().clone() for k, p in params.items()}
            mu = {k: torch.zeros_like(p) for k, p in params.items()}
            nu = {k: torch.zeros_like(p) for k, p in params.items()}
            o = self.cfg["optim"]
            lrs = {k: o["lr_init"] for k in dict(net.named_parameters())}
            lrs.update({"xyz": o["position_lr_init"] * 2.5, "features_dc": o["feature_lr"],
                        "features_rest": o["feature_lr"] / 20.0, "scaling": o["scaling_lr"],
                        "rotation": o["rotation_lr"], "opacity": o["opacity_lr"]})
            out = {"loss": [], "terms1": {}}
            for t in range(CHECK_STEPS):
                loss = self._ref_loss(net, spl, self.inp.items[self.inp.order[t]], tf32=tf32,
                                      terms=out["terms1"] if t == 0 else None)
                g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
                g = dict(zip(params, g))
                out["loss"].append(float(loss.detach()))
                if t == 0:
                    out["g1"] = {k: x.clone() for k, x in g.items()}
                with torch.no_grad():
                    ref_adam.step({k: p.data for k, p in params.items()}, g, mu, nu, lrs, t + 1)
            out["change"] = {k: params[k].detach() - p0[k] for k in params}
            return out

    # ---- counters for the per-layer metrics ------------------------------------------
    @torch.no_grad()
    def counters(self, first: int, count: int) -> dict:
        """The work of the traced steps' items, counted on the reference at
        the initial weights (the counters read nothing the program made)."""
        from perfbench.counters import composite, ssim, styleunet

        net, spl = self._ref_model()
        seen = {}
        for i in range(first, first + count):
            k = self.inp.order[i]
            if k not in seen:
                seen[k] = self._ref_loss(net, spl, self.inp.items[k], with_counts=True)
        counts = [seen[self.inp.order[i]] for i in range(first, first + count)]
        c0 = self.inp.items[0].cam
        net_f = styleunet.flops(self.cfg["texture_size"], self.cfg["sh_degree"], backward=True)
        ss = ssim.flops(c0.width, c0.height, backward=True)
        comp = sum(composite.flops(c, backward=True) for c in counts) / len(counts)
        return {"step_flops": net_f + ss + comp,
                "composite_fwd": _mean([composite.forward(c, for_backward=True) for c in counts]),
                "composite_bwd": _mean([composite.backward(c) for c in counts])}


def _mean(rows: list) -> dict:
    return {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}


def _safe_norm(x, dim):
    sq = (x * x).sum(dim)
    return torch.sqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq)) * (sq != 0.0)
