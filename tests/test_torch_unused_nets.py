"""The nets no stage script runs, in the port against the Flax modules:
the wavelet ``Discriminator`` (with and without the pose-conditioned head),
``AppearanceNet`` and ``ConvUNet``. Each takes the Flax module's seeded init
through ``training/checkpoints.py::flax_state_to_torch`` and runs on the same
seeded input on the CPU.

Tolerances: AppearanceNet rtol 1e-5 / atol 1e-6 (three small float32
matmuls); ConvUNet atol 1e-5 (six float32 convolutions that XLA and PyTorch
sum in different orders; outputs O(0.1)); Discriminator rtol 1e-4 / atol 1e-5
(about twenty convolutions and a 8,192-wide dense layer, outputs O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.models import appearance as JA
from gaussian_garments_tpu.models import styleunet as JSU
from gaussian_garments_tpu_torch.models import appearance as TA
from gaussian_garments_tpu_torch.models import styleunet as TSU
from gaussian_garments_tpu_torch.training.checkpoints import flax_state_to_torch


def _load(module: torch.nn.Module, flax_vars) -> torch.nn.Module:
    module.load_state_dict(flax_state_to_torch(jax.tree.map(np.asarray, flax_vars["params"])),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("c_dim", [0, 8])
def test_discriminator_matches_flax(c_dim):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 32, 32).astype(np.float32)
    pose = rng.randn(4, c_dim).astype(np.float32) if c_dim else None
    jnet = JSU.Discriminator(size=32, img_channel=6, c_dim=c_dim)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(pose),) if c_dim else ())
    jvars = jnet.init(jax.random.PRNGKey(1), *jargs)
    want = np.asarray(jnet.apply(jvars, *jargs))
    tnet = _load(TSU.Discriminator(32, img_channel=6, c_dim=c_dim), jvars)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), None if pose is None else torch.from_numpy(pose)).numpy()
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_minibatch_stddev_matches_flax():
    x = np.random.RandomState(2).randn(8, 6, 4, 4).astype(np.float32)
    np.testing.assert_allclose(TSU._minibatch_stddev(torch.from_numpy(x)).numpy(),
                               np.asarray(JSU._minibatch_stddev(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_appearance_net_matches_flax():
    x = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    jnet = JA.AppearanceNet(out_dim=3, hidden=(16, 16))
    jvars = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tnet = _load(TA.AppearanceNet(7, out_dim=3, hidden=(16, 16)), jvars)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(jvars, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(6, 6), (7, 10)])
def test_conv_unet_matches_flax(hw):
    """Even and odd sides: Flax's stride-2 SAME pads (0, 1) on an even side,
    and its nearest resize samples at half-pixel centres."""
    x = np.random.RandomState(4).randn(2, 5, *hw).astype(np.float32)
    jnet = JA.ConvUNet(out_ch=3, base=4)
    jvars = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tnet = _load(TA.ConvUNet(5, out_ch=3, base=4), jvars)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    want = np.asarray(jnet.apply(jvars, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, *hw)
    np.testing.assert_allclose(got, want, atol=1e-5)
