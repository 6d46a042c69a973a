"""The bf16 net's render against the float32 net's on a trained state, in
both packages: the port trains the case of ``torch_s3_case`` in float32, and
each package renders the state with its float32 and its bf16 AvatarNet.
``tests/test_torch_unet_bf16.py`` holds the port to the JAX package there;
run as a script it prints the readings along a longer training:

    JAX_PLATFORMS=cpu python tests/torch_bf16_trained.py --res 64 --steps 300 --every 100

Each line: the step, the img loss, each package's bf16-against-f32 PSNR,
and the PSNR between the two packages' bf16 renders; then, for the port on
item 0, the PSNR of its bf16 Δxyz alone and of its bf16 ΔSH alone against
the float32 render, and the bf16 error of Δxyz over |Δxyz|
(``chip_smoke.bf16_render_split``, which reads the same on the card).
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import torch_s3_case as C  # noqa: E402
from gaussian_garments_tpu.models import gaussian as JG  # noqa: E402
from gaussian_garments_tpu.models.avatar_net import AvatarNet as JAvatarNet  # noqa: E402
from gaussian_garments_tpu.training import s3 as JS3  # noqa: E402
from gaussian_garments_tpu_torch.models import avatar_gaussian as TAG  # noqa: E402
from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet as TAvatarNet  # noqa: E402
from gaussian_garments_tpu_torch.models.gaussian import PARAM_NAMES  # noqa: E402
from gaussian_garments_tpu_torch.training import checkpoints as tckpt  # noqa: E402
from gaussian_garments_tpu_torch.training import s3 as TS3  # noqa: E402


def train(case, res, steps, every=0, report=None):
    """The port's float32 state after ``steps`` steps on ``case`` (built at
    texture ``res``); ``report(step, state, losses)`` every ``every`` steps."""
    tbind = TAG.build_binding(case["uvs"], case["faces"], res, bind_map=case["bind_map"],
                              device="cpu")[0]
    state = tckpt.s3_state_from_jax(jax.tree.map(np.asarray, case["jstate"]), device="cpu")
    step = TS3.make_s3_step(TAvatarNet(res, C.DEG), C.s3_args(), sh_degree=C.DEG,
                            vis_raster_hw=(C.HW, C.HW))
    item = C.port_item(case["item"])
    for i in range(1, steps + 1):
        state, losses = step(state, tbind, case["tf"], item)
        if report is not None and every and i % every == 0:
            report(i, state, losses)
    return state


def renders(case, state, res):
    """{(package, "f32" | "bf16"): (B,3,H,W) eval render in [0, 1]} of the
    port's ``state`` (the JAX package reads it through ``s3_state_to_jax``)."""
    tbind = TAG.build_binding(case["uvs"], case["faces"], res, bind_map=case["bind_map"],
                              device="cpu")[0]
    tree = tckpt.s3_state_to_jax(state)
    jstate = case["jstate"].replace(
        net_params=jax.tree.map(jnp.asarray, tree["net_params"]),
        net_buffers=jax.tree.map(jnp.asarray, tree["net_buffers"]),
        splats=JG.GaussianParams(**{k: jnp.asarray(getattr(tree["splats"], k))
                                    for k in PARAM_NAMES}))
    kw = dict(sh_degree=C.DEG, vis_raster_hw=(C.HW, C.HW))
    out = {}
    for name, (jdt, tdt) in {"f32": (jnp.float32, torch.float32),
                             "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        jnet = JAvatarNet(texture_size=res, sh_degree=C.DEG, act_dtype=jdt)
        out["jax", name] = np.clip(np.asarray(JS3.make_s3_eval(jnet, raster_cfg=C.CFG, **kw)(
            jstate, case["jbind"], case["jf"], C.jax_item(case["item"]))), 0, 1)
        out["port", name] = torch.clamp(TS3.make_s3_eval(TAvatarNet(res, C.DEG, act_dtype=tdt),
                                                         **kw)(
            state, tbind, case["tf"], C.port_item(case["item"])), 0, 1).numpy()
    return out


def mse(a, b) -> float:
    return float(np.mean((a - b) ** 2))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--every", type=int, default=100)
    args = parser.parse_args(argv)
    case = C.build_case(res=args.res)
    psnr = lambda a, b: 10 * np.log10(1.0 / mse(a, b))

    from chip_smoke import bf16_render_split

    torch.set_num_threads(4)
    tbind = TAG.build_binding(case["uvs"], case["faces"], args.res,
                              bind_map=case["bind_map"], device="cpu")[0]
    item0 = C.port_item({k: v[:1] for k, v in case["item"].items()})

    def report(i, state, losses):
        r = renders(case, state, args.res)
        q = bf16_render_split(torch, TAvatarNet(args.res, C.DEG), state, tbind, case["tf"], item0)
        print(f"step {i}: img loss {float(losses['img']):.5f}; bf16 against f32 PSNR, "
              f"JAX {psnr(r['jax', 'bf16'], r['jax', 'f32']):.2f} dB, port "
              f"{psnr(r['port', 'bf16'], r['port', 'f32']):.2f} dB; port bf16 against JAX bf16 "
              f"{psnr(r['port', 'bf16'], r['jax', 'bf16']):.2f} dB; port, item 0: Δxyz alone "
              f"{q['dxyz']['psnr']:.2f} dB, ΔSH alone {q['dsh']['psnr']:.2f} dB, Δxyz error "
              f"{q['dxyz_err_rel']:.4f} of |Δxyz| (mean {q['dxyz_mean']:.3f})", flush=True)

    report(0, train(case, args.res, 0), {"img": float("nan")})
    train(case, args.res, args.steps, args.every, report)


if __name__ == "__main__":
    main()
