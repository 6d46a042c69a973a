"""Write the JAX drive's dataset into a root of the port's production drive,
so that the port trains on the JAX drive's own ground truth.

    JAX_PLATFORMS=cpu python tests/torch_jax_dataset.py ROOT
    python -m gaussian_garments_tpu_torch.prod_drive --root ROOT --until s2_sequence

It calls the JAX package's ``write_reference_layout`` with the JAX drive's
arguments (``scripts/prod_drive.py::ensure_dataset``: 12 cameras at 1024², 8
frames, a 48×48 sheet) and touches the marker the drive looks for, so the
drive's dataset leg is skipped. At this size the JAX writer renders with its
tiled compositor, whose tiles hold 192 splats: the crowded tiles drop splats,
and the garment loses most of its pixels (``tests/test_torch_prod_quality.py``).
"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FRAMES, CAMS, RES, NX = 8, 12, 1024, 48


def main(root):
    sys.path.insert(0, str(REPO))
    from gaussian_garments_tpu.data.synthetic import write_reference_layout

    root = Path(root)
    write_reference_layout(root / "data", root / "out", "subj", "seq1", n_cams=CAMS,
                           n_frames=FRAMES, nx=NX, ny=NX, res=RES)
    (root / "data/subj/seq1" / f"done_{FRAMES}_{CAMS}_{RES}_{NX}").touch()


if __name__ == "__main__":
    main(sys.argv[1])
