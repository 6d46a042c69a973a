"""Convert a stage-3 orbax checkpoint to the pickle layout.

The JAX package's ``s3_appearance.py --ckpt_backend orbax`` writes
``<model>/ckpt/net.orbax``. Reading it needs jax and orbax, which the
PyTorch package does not use, so the port refuses it and reads the pickle
layout (``ckpt/{net.pkl,optm.pkl,info.txt}``) instead. This script reads the
orbax checkpoint through the JAX package's ``load_s3_ckpt`` and writes the
pickle layout through its ``save_s3_ckpt``. Run it where jax and orbax are
installed; the source checkpoint is left as it is.

    python scripts/orbax_to_pickle.py MODEL_PATH OUT_PATH [--name ckpt]

then resume the port from ``OUT_PATH`` (``s3_appearance --ckpt_path OUT_PATH``).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tree_adam(x, splats: bool):
    """orbax restores NamedTuples and dataclasses as dicts; rebuild them."""
    from gaussian_garments_tpu.models.adam import TreeAdam
    from gaussian_garments_tpu.models.gaussian import GaussianParams

    if isinstance(x, dict):
        x = TreeAdam(step=x["step"], mu=x["mu"], nu=x["nu"])
    if splats:
        x = x._replace(**{k: GaussianParams(**v) if isinstance(v, dict) else v
                          for k, v in (("mu", x.mu), ("nu", x.nu))})
    return x


def convert(model_path, out_path, name: str = "ckpt") -> Path:
    """Read ``<model_path>/<name>/net.orbax``; write ``<out_path>/<name>/``
    in the pickle layout. Returns the written directory."""
    from gaussian_garments_tpu.training.checkpoints import load_s3_ckpt, save_s3_ckpt

    src = Path(model_path) / name / "net.orbax"
    if not src.is_dir():
        raise FileNotFoundError(f"{src} is not an orbax checkpoint directory")
    if Path(out_path).absolute() == Path(model_path).absolute():
        raise ValueError("OUT_PATH must differ from MODEL_PATH: the JAX package reads "
                         "net.orbax in preference to net.pkl")
    ck = load_s3_ckpt(model_path, name=name)
    has_optm = "net_adam" in ck
    state = SimpleNamespace(
        net_params=ck["net_params"], net_buffers=ck["net_buffers"], splats=ck["splats"],
        net_adam=_tree_adam(ck["net_adam"], False) if has_optm else None,
        splat_adam=_tree_adam(ck["splat_adam"], True) if has_optm else None,
        iteration=ck.get("iteration", 0))
    save_s3_ckpt(out_path, state, int(ck["epoch"]), active_sh_degree=int(ck["activate_sh_degree"]),
                 save_optm=has_optm, name=name, backend="pickle")
    return Path(out_path) / name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_path", help="the stage-3 directory holding <name>/net.orbax")
    ap.add_argument("out_path", help="where to write <name>/{net.pkl,optm.pkl,info.txt}")
    ap.add_argument("--name", default="ckpt")
    args = ap.parse_args(argv)
    out = convert(args.model_path, args.out_path, args.name)
    print(f"wrote {out}/net.pkl")


if __name__ == "__main__":
    main()
