"""Gaussian-Garments on PyTorch and CUDA (NVIDIA Hopper).

A port of ``gaussian_garments_tpu`` (JAX on a TPU) that keeps the JAX
package's module names and layout, so that each module's counterpart is easy
to find. The JAX package stays the reference: every module here is tested
against the JAX function it replaces on the same inputs.

The port imports ``torch`` and nothing of ``jax``, ``flax``, ``orbax`` or the
JAX package ``gaussian_garments_tpu``, not even its modules that hold no jax:
it keeps its own copies of those (``config.py``, ``utils/io.py``,
``native/``).

The splat compositor is two hand-written CUDA kernels, forward
(``csrc/composite_fwd.cu``) and backward (``csrc/composite_bwd.cu``), both
wrapped in ``ops/tiles.py``; everything else is plain torch.

Public constructors and entry points run on the card: their ``device``
defaults to ``default_device()``, which raises without a GPU. Only an explicit
``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

__version__ = "0.2.0"


def default_device():
    """``cuda:0``; raises RuntimeError when no GPU is present."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False; "
                           "pass device='cpu' (or --device cpu) to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device=None):
    """``device`` as a torch.device; None means ``default_device()``. A CUDA
    device raises when no GPU is present."""
    import torch

    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        default_device()
    return device


def pin_full_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and for matmuls.

    PyTorch runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
    digits. The StyleUNet and the SSIM blur are convolutions and the JAX
    reference is full f32, so every entry point of the port calls this first."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
