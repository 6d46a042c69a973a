"""Stage-2 registration iterations in sequence mode: the program's
``training.s2.make_s2_step`` step (mode ``seq``: the garment's vertices
only, with the cloth energies), ``cameras_per_step`` cameras an iteration
drawn by ``s2_registration``'s stack rule, iterations without the body and with it
alternating in blocks, and the plain reference that checks the first three.

Inputs, made here from the seed and handed alike to both sides: the
template (the garment at rest), the garment's previous two frames and the
frame being tracked, the body, the rig and each camera's ground truth of the
tracked frame, and the splats bound to the template's faces. The program
builds its own mesh state (connectivity, virtual edges, the momentum
rest shape, the collision binding); the reference builds its own.

Correctness follows ``harness.training``, with the vertices as the one leaf.
"""
from __future__ import annotations

import random
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.gen import scene, weights
from perfbench.harness.training import TrainingEntry, reference_mode
from perfbench.reference import adam as ref_adam
from perfbench.reference import cloth as C
from perfbench.reference import losses as ref_losses
from perfbench.reference import render as R
from perfbench.reference import texels as T

CHECK_STEPS = 3
C0 = 0.28209479177387814


def uses_body(i: int, traffic: dict) -> bool:
    """Iteration ``i`` (0-based) runs with the body: blocks of ``block[0]``
    iterations without it, then ``block[1]`` with it, from ``block_offset``."""
    free, body = traffic["block"]
    return (i + traffic["block_offset"]) % (free + body) >= free


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    g, dev = cfg["garment"], device
    rng = np.random.default_rng(int(seed))
    faces = scene.grid_faces(g["nx"], g["ny"])
    uvs = scene.garment_uvs(g["nx"], g["ny"])
    f_t = torch.as_tensor(faces, device=dev)
    motion = scene.garment_motion(g, rng)
    t0 = traffic["frame"]
    pose = lambda t: torch.as_tensor(scene.garment_pose(g, motion, t), device=dev)
    vt = torch.as_tensor(scene.garment_pose(g, None, 0.0), device=dev)
    prev2, prev1, cur = pose(t0 - 2), pose(t0 - 1), pose(t0)
    bv, bf = scene.body(cfg["body"])
    rig = scene.rig(cfg["rig"], dev)
    gts = [scene.ground_truth(cur, f_t, torch.as_tensor(uvs, device=dev), c,
                              g["checker_squares"]) for c in rig]
    centres = np.stack([c.campos.cpu().numpy() for c in rig])
    extent = float(np.linalg.norm(centres - centres.mean(0), axis=1).max() * 1.1)
    # splats: one a face, then extra ones on seeded faces
    s = cfg["splats"]
    n_faces = len(faces)
    binding = np.concatenate([np.arange(n_faces), rng.integers(0, n_faces, s["extra"])])
    r = torch.randn((len(binding), 13), generator=weights.generator(seed, dev, 3), device=dev)
    uv_c = torch.as_tensor(uvs[faces].mean(1), device=dev)[torch.as_tensor(binding, device=dev)]
    colour = scene.checker(uv_c, g["checker_squares"])
    splats = {"xyz": s["xyz_sd"] * r[:, 0:3],
              "features_dc": ((colour - 0.5) / C0 + s["dc_sd"] * r[:, 3:6])[:, None, :],
              "features_rest": torch.zeros((len(binding), 0, 3), device=dev),
              "scaling": s["log_scale"] + s["log_scale_sd"] * r[:, 6:9],
              "rotation": torch.cat([torch.ones((len(binding), 1), device=dev),
                                     s["rotation_sd"] * r[:, 9:12]], 1),
              "opacity": s["opacity_logit"] + s["opacity_sd"] * r[:, 12:13]}
    # s2_registration's camera draw: pop a random one off a stack refilled when empty
    pick, stack, cams = random.Random(int(seed)), [], []
    k = traffic["cameras_per_step"]
    for _ in range(traffic["max_steps"]):
        step = []
        while len(step) < k:
            if not stack:
                stack = list(range(len(rig)))
            step.append(stack.pop(pick.randint(0, len(stack) - 1)))
        cams.append(step)
    return SimpleNamespace(faces=faces, f=f_t, vt=vt, prev2=prev2, prev1=prev1,
                           start=prev1 + (prev1 - prev2), body_v=bv, body_f=bf, rig=rig, gts=gts,
                           extent=extent, binding=binding, splats=splats, cams=cams)


class Entry(TrainingEntry):
    """One configuration under s2 sequence traffic; see the module doc."""

    def _lr(self):
        return self.cfg["optim"]["position_lr_init"] * self.inp.extent

    # ---- program side -------------------------------------------------------------
    def setup(self, fault=None):
        from gaussian_garments_tpu_torch import pin_full_f32
        from gaussian_garments_tpu_torch.models import gaussian as G
        from gaussian_garments_tpu_torch.models import mesh_model as MM
        from gaussian_garments_tpu_torch.scene import bind_collision_faces
        from gaussian_garments_tpu_torch.training import s2 as S2

        dev = self.device
        pin_full_f32()
        t = time.perf_counter()
        inp = self.inp = make_inputs(self.cfg, self.traffic, self.seed, dev)
        t = self._mark("inputs", t)
        mesh = MM.create(inp.vt.cpu().numpy(), inp.faces, device=dev)
        mesh = MM.momentum_update(mesh, inp.prev1.clone())
        mesh = mesh.replace(v=inp.start.clone(), tar_v=inp.start.clone())
        nn = bind_collision_faces(mesh.v.cpu().numpy(), inp.body_v, inp.body_f)
        mesh = MM.init_body(mesh, inp.body_v, inp.body_f, nn)
        params = G.GaussianParams(**{k: v.clone() for k, v in inp.splats.items()})
        m = params.xyz.shape[0]
        z = lambda *s: torch.zeros(s, device=dev)
        aux = G.GaussianAux(alive=torch.ones(m, dtype=torch.bool, device=dev),
                            max_radii2d=z(m), xyz_gradient_accum=z(m, 1), denom=z(m, 1))
        state = S2.init_state(params, aux, inp.binding, mesh)
        opt = SimpleNamespace(**self.cfg["optim"])
        steps = {b: S2.make_s2_step(opt, mode="seq", use_body=b, active_sh_degree=0)
                 for b in (False, True)}
        if fault is not None:
            steps = {b: fault(s) for b, s in steps.items()}
        self.prog = SimpleNamespace(steps=steps, state=state, bg=torch.zeros(3, device=dev))
        t = self._mark("program", t)
        v0 = state.mesh.v
        for i in range(CHECK_STEPS):
            self._run(i)
            if i == 0:
                self.readings["g1"] = {"v": self.prog.state.vert_adam.mu / (1 - ref_adam.B1)}
        self.readings["change"] = {"v": self.prog.state.mesh.v - v0}
        self.readings["loss"] = list(self.losses[:CHECK_STEPS])
        for i in range(CHECK_STEPS, CHECK_STEPS + self.traffic["warmup_steps"]):
            self._run(i)
        self.n = CHECK_STEPS + self.traffic["warmup_steps"]
        self._mark("first_steps", t)

    def _batch(self, i):
        from gaussian_garments_tpu_torch.renderer import BatchedCameras

        ids = self.inp.cams[i]
        cams = [self.inp.rig[k] for k in ids]
        return BatchedCameras(
            world_view=torch.stack([c.world_view for c in cams]),
            full_proj=torch.stack([c.full_proj for c in cams]),
            campos=torch.stack([c.campos for c in cams]),
            tanfovx=tuple(c.tanfovx for c in cams), tanfovy=tuple(c.tanfovy for c in cams),
            image=torch.stack([self.inp.gts[k][0] for k in ids]),
            mask=torch.stack([self.inp.gts[k][1] for k in ids]),
            width=cams[0].width, height=cams[0].height)

    def _run(self, i):
        p = self.prog
        lr = self._lr()
        p.state, _, metrics = p.steps[uses_body(i, self.traffic)](p.state, self._batch(i), p.bg,
                                                                  lr, lr)
        self.losses.append(float(metrics["loss"]))

    # ---- reference --------------------------------------------------------------------
    def _splat_model(self):
        inp = self.inp
        return {k: v.clone() for k, v in inp.splats.items()}, torch.as_tensor(inp.binding,
                                                                              device=self.device)

    def _render(self, v, spl, binding, cam_id, counts=False, tf32=False):
        c = self.inp.rig[cam_id]
        fr = T.face_frames(v, self.inp.f)
        rot, s = fr.rot[binding], fr.scale[binding][:, None]
        means = torch.einsum("gij,gj->gi", rot, spl["xyz"]) * s + fr.center[binding]
        rots = T.quat_normalize(T.quat_multiply(fr.quat[binding],
                                                T.quat_normalize(spl["rotation"])))
        sh = R.full_sh(spl["features_dc"], spl["features_rest"])
        proj = R.project(means, torch.exp(spl["scaling"]) * s, rots, sh,
                         torch.sigmoid(spl["opacity"])[:, 0], c, 0)
        pairs = R.tile_pairs(proj, c.width, c.height)
        if counts:
            return R.count_terms(proj, pairs, c.width, c.height)
        return R.composite(proj, pairs, c.width, c.height, tf32)[0]

    def _ref_loss(self, cloth, v, spl, binding, i, half_batch=False, tf32=False):
        o = self.cfg["optim"]
        ids = self.inp.cams[i]
        if half_batch:
            ids = ids[:len(ids) // 2]
        img = torch.stack([self._render(v, spl, binding, k, tf32=tf32) for k in ids])
        gt = torch.stack([self.inp.gts[k][0] for k in ids])
        mask = torch.stack([self.inp.gts[k][1] for k in ids]) if o["only_foreground_loss"] \
            else None
        lam = o["lambda_dssim"]
        return (ref_losses.l1(img, gt, mask) * (1.0 - lam)
                + 1.0 - ref_losses.ssim(img, gt, mask, tf32=tf32) * lam
                + C.energies(cloth, v, o, uses_body(i, self.traffic)))

    def reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The reference's losses, first gradient and change over the first
        CHECK_STEPS iterations, in float32; with ``tf32`` the control (TF32
        for matmuls, the compositing's and SSIM's operands rounded to TF32), with
        ``half_batch`` the fault that renders half of each step's cameras and
        takes the mean over them."""
        with reference_mode(tf32, self.device):
            inp, dev = self.inp, self.device
            bv = torch.as_tensor(inp.body_v, device=dev)
            bf = torch.as_tensor(inp.body_f, device=dev)
            cloth = C.build(inp.vt, inp.f, inp.prev1, inp.start, bv, bf)
            spl, binding = self._splat_model()
            v = inp.start.clone().requires_grad_(True)
            mu, nu = {"v": torch.zeros_like(v)}, {"v": torch.zeros_like(v)}
            out = {"loss": []}
            for t in range(CHECK_STEPS):
                loss = self._ref_loss(cloth, v, spl, binding, t, half_batch, tf32)
                g, = torch.autograd.grad(loss, [v])
                out["loss"].append(float(loss.detach()))
                if t == 0:
                    out["g1"] = {"v": g.clone()}
                with torch.no_grad():
                    ref_adam.step({"v": v.data}, {"v": g}, mu, nu, {"v": self._lr()}, t + 1)
            out["change"] = {"v": v.detach() - inp.start}
            return out

    # ---- counters for the per-layer metrics ------------------------------------------
    @torch.no_grad()
    def counters(self, first: int, count: int) -> dict:
        """The compositing work of the traced iterations' cameras, counted on
        the reference at the starting vertices; per iteration."""
        from perfbench.counters import composite, ssim

        spl, binding = self._splat_model()
        c0 = self.inp.rig[0]
        fw, bw, fl = [], [], []
        for i in range(first, first + count):
            cs = [self._render(self.inp.start, spl, binding, k, counts=True)
                  for k in self.inp.cams[i]]
            fw.append(sum(composite.forward(c, for_backward=True)["least_s"] for c in cs))
            bw.append(sum(composite.backward(c)["least_s"] for c in cs))
            fl.append(sum(composite.flops(c, backward=True) for c in cs))
        k = len(self.inp.cams[first])
        return {"step_flops": sum(fl) / count + k * ssim.flops(c0.width, c0.height, True),
                "composite_fwd": {"least_s": sum(fw) / count},
                "composite_bwd": {"least_s": sum(bw) / count}}
