"""A stage-3 case shared by the port's bf16 and dense-texel tests: the
synthetic sheet of ``tests/test_s3.py`` with its UVs inset into [0.1, 0.9]²
(so about a third of the texels lie outside the island), seeded splats, 2
items at 64×64, and a Flax-initialised ``S3State``, built as numpy so that
both packages start from the same arrays.
"""
from argparse import ArgumentParser, Namespace

import jax.numpy as jnp
import numpy as np
import torch

from gaussian_garments_tpu.config import OptimizationParams
from gaussian_garments_tpu.data import synthetic as jsyn
from gaussian_garments_tpu.data.baker import bake_textures
from gaussian_garments_tpu.models import avatar_gaussian as JAG
from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet
from gaussian_garments_tpu.renderer import RasterConfig as JCfg
from gaussian_garments_tpu.training import s3 as JS3
from gaussian_garments_tpu_torch.data.synthetic import inset_uvs
from gaussian_garments_tpu_torch.training import s3 as TS3

RES, DEG, B, HW, INSET = 32, 1, 2, 64, 0.1
# tiles of 16 px holding every splat of the scene: no overflow in the JAX
# tiled backend, which would drop splats the port keeps
CFG = JCfg(tile_capacity=1024, chunk_tiles=16)


def s3_args(lr: float = 5e-4) -> Namespace:
    parser = ArgumentParser()
    opt = OptimizationParams(parser).extract(parser.parse_args([]))
    return Namespace(**{**vars(opt), "lr_init": lr})


def build_case(seed: int = 0, res: int = RES) -> dict:
    """Scene, compact JAX binding and bind map at texture ``res``, the item as
    numpy (``vis`` from the JAX depth test on the compact binding), the JAX
    net and state."""
    cams, verts, faces, uvs, _ = jsyn.make_scene(n_cams=B, nx=8, ny=8, width=HW, height=HW)
    uvs = inset_uvs(uvs, INSET)
    jbind, bind_map = JAG.build_binding(uvs, faces, res)
    n = int(jbind.binding.shape[0])
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    splats = {"xyz": np.zeros((n, 3)), "features_dc": rng.randn(n, 1, 3) * 0.3,
              "features_rest": rng.randn(n, 3, 3) * 0.05,
              "scaling": rng.randn(n, 3) * 0.2 - 4.0,
              "rotation": np.array([[1.0, 0, 0, 0]]) + rng.randn(n, 4) * 0.2,
              "opacity": rng.randn(n, 1) * 0.5 + 1.0}
    splats = {k: f32(v) for k, v in splats.items()}
    amb, nrm = bake_textures(jbind, verts, faces, n_samples=8)
    mesh_v = np.stack([verts + f32(rng.randn(*verts.shape) * 0.005) for _ in range(B)])
    jf = jnp.asarray(faces.astype(np.int32))
    item = dict(
        image=np.stack([np.asarray(c.original_image) for c in cams]),
        mask=np.stack([np.asarray(c.gt_alpha_mask) for c in cams]),
        bg=f32(rng.rand(B, 3)), mesh_v=f32(mesh_v),
        ambient=np.stack([amb] * B), normal=np.stack([nrm] * B),
        world_view=np.stack([np.asarray(c.world_view_transform) for c in cams]),
        full_proj=np.stack([np.asarray(c.full_proj_transform) for c in cams]),
        campos=np.stack([np.asarray(c.camera_center) for c in cams]),
        tanfovx=[c.tanfovx for c in cams], tanfovy=[c.tanfovy for c in cams])
    item["vis"] = np.stack([np.asarray(JAG.get_visible_mask_depth(
        jbind, jnp.asarray(mesh_v[b]), jf, jnp.asarray(item["world_view"][b]),
        jnp.asarray(item["full_proj"][b]), image_width=HW, image_height=HW)) for b in range(B)]
    ).astype(np.float32)
    jnet = JAvatarNet(texture_size=res, sh_degree=DEG)
    jsplats = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in splats.items()})
    jstate = JS3.init_state(jnet, jbind, jsplats, verts, faces, jax_item(item))
    return dict(verts=verts, faces=faces, uvs=uvs, bind_map=bind_map, jbind=jbind, jf=jf,
                tf=torch.as_tensor(faces), item=item, jnet=jnet, jstate=jstate)


def jax_item(item: dict, vis=None) -> "JS3.S3Item":
    arrays = {**item, "vis": item["vis"] if vis is None else vis}
    return JS3.S3Item(**{k: jnp.asarray(v) for k, v in arrays.items()}, width=HW, height=HW)


def port_item(item: dict, vis=None) -> "TS3.S3Item":
    arrays = {**item, "vis": item["vis"] if vis is None else vis}
    return TS3.S3Item(**{k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()
                         if k not in ("tanfovx", "tanfovy")},
                      tanfovx=tuple(item["tanfovx"]), tanfovy=tuple(item["tanfovy"]),
                      width=HW, height=HW)


def write_s3_layout(root, *, uv_inset: float = INSET) -> dict:
    """What ``s3_appearance`` reads, without running stage 2: a 6×6 sheet
    seen by 3 cameras over 2 frames at 48² under ``root/data`` (4 training
    items an epoch with llffhold 12), and under ``root/out/subj`` the
    template with inset UVs, the stage-2 meshes and a seeded Template point
    cloud (world and local). Returns the roots and the template."""
    from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout
    from gaussian_garments_tpu_torch.models import gaussian as TG
    from gaussian_garments_tpu_torch.utils.io import write_obj

    data, out = root / "data", root / "out"
    info = write_reference_layout(data, out, "subj", "seq", n_cams=3, n_frames=2, nx=6, ny=6,
                                  res=48, device="cpu")
    subj = out / "subj"
    uvs = inset_uvs(info["uvs"], uv_inset)
    write_obj({"vertices": info["verts"], "faces": info["faces"], "uvs": uvs,
               "texture_faces": info["faces"]}, subj / "stage1" / "template_uv.obj")
    meshes = subj / "stage2" / "seq" / "meshes"
    meshes.mkdir(parents=True)
    for t, v in enumerate(info["frames"]):
        write_obj({"vertices": v, "faces": info["faces"]}, meshes / f"frame_{t:05d}.obj")
    centres = info["verts"][info["faces"]].mean(1)
    n = len(centres)
    rng = np.random.RandomState(5)
    splats = TG.GaussianParams(
        xyz=torch.as_tensor(centres), features_dc=torch.as_tensor(
            rng.randn(n, 1, 3).astype(np.float32) * 0.3),
        features_rest=torch.zeros((n, 0, 3)), scaling=torch.full((n, 3), -3.5),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1), opacity=torch.full((n, 1), 1.0))
    template = subj / "stage2" / "Template"
    template.mkdir(parents=True)
    for name in ("point_cloud.ply", "local_point_cloud.ply"):
        TG.save_ply(template / name, splats)
    return {"data": data, "out": out, "uvs": uvs, "faces": info["faces"]}


def run_s3(argv, roots, monkeypatch) -> dict:
    """``s3_appearance.main`` on the CPU at texture 32, SH degree 1, one
    mid-epoch save, over the roots of ``write_s3_layout``."""
    from gaussian_garments_tpu_torch import config as tcfg
    from gaussian_garments_tpu_torch import s3_appearance

    monkeypatch.setattr(tcfg.DEFAULTS, "data_root", str(roots["data"]))
    monkeypatch.setattr(tcfg.DEFAULTS, "output_root", str(roots["out"]))
    return s3_appearance.main(["-s", "subj", "--texture_size", str(RES), "--sh_degree",
                               str(DEG), "--save_iterations", "2", "--pre_train_iterations",
                               "1", "--eval_items", "1", "--device", "cpu", *argv])
