"""The port's stage-3 checkpoints under ``--ckpt_backend orbax``: the pickle
layout written with the two properties the JAX package's orbax backend has
(``tests/test_aux.py::TestS3Checkpoint``): asynchronous saves that overlap
the caller and are waited for, and a commit that survives a killed writer
and a same-epoch re-save. Also: the JAX package reads what the port wrote,
a committed ``net.orbax`` is refused by name while an uncommitted one is no
checkpoint, and an orbax checkpoint written by the JAX package, converted by
``scripts/orbax_to_pickle.py``, loads into the port equal leaf for leaf.
All comparisons are exact: the files hold the same float32 arrays.
"""
import os
import sys
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.models import gaussian as JG
from gaussian_garments_tpu.models.adam import tree_adam_init as j_tree_adam_init
from gaussian_garments_tpu.training import checkpoints as jckpt
from gaussian_garments_tpu_torch.models.adam import TreeAdam
from gaussian_garments_tpu_torch.models.gaussian import PARAM_NAMES, GaussianParams
from gaussian_garments_tpu_torch.training import checkpoints as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"xyz": (5, 3), "features_dc": (5, 1, 3), "features_rest": (5, 3, 3),
          "scaling": (5, 3), "rotation": (5, 4), "opacity": (5, 1)}


def _tree(value: float, n: int = 5):
    """A port checkpoint payload whose every leaf is ``value``-derived."""
    splats = GaussianParams(**{k: np.full(s, value, np.float32) + np.arange(np.prod(s))
                               .reshape(s).astype(np.float32) for k, s in SHAPES.items()})
    params = {"style_0": {"weight": np.full((2, 2), value, np.float32)}}
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                       for k, v in t.items()}
    zsplats = GaussianParams(**{k: np.zeros(s, np.float32) for k, s in SHAPES.items()})
    return dict(net_params=params, net_buffers={"noise_0": np.zeros((1, 1, 4, 4), np.float32)},
                splats=splats, net_adam=TreeAdam(np.int32(3), zeros(params), zeros(params)),
                splat_adam=TreeAdam(np.int32(3), zsplats, zsplats), iteration=int(value))


def test_async_roundtrip(tmp_path, monkeypatch):
    """An async save returns before its files are written; the write lands
    after the caller goes on, and a load waits for it."""
    gate = threading.Event()
    real = tckpt._write_all

    def slow(path, files):
        gate.wait(10)
        real(path, files)

    monkeypatch.setattr(tckpt, "_write_all", slow)
    tckpt.save_s3_ckpt(tmp_path, epoch=4, async_save=True, **_tree(7.0))
    assert not (tmp_path / "ckpt" / "net.pkl").exists()   # the caller was not blocked
    gate.set()
    ck = tckpt.load_s3_ckpt(tmp_path)                       # waits for the writer
    assert ck["epoch"] == 4 and ck["iteration"] == 7
    np.testing.assert_array_equal(ck["net_params"]["style_0"]["weight"], 7.0)
    np.testing.assert_array_equal(ck["splats"].xyz, _tree(7.0)["splats"].xyz)
    assert (tmp_path / "ckpt" / "info.txt").read_text() == "Epoch 4\n"


def test_killed_writer_keeps_the_last_commit(tmp_path, monkeypatch):
    """A writer killed before its first commit leaves no checkpoint; one
    killed mid-save leaves the previous commit loadable and a stale
    temporary directory, which the next save removes."""
    ck_dir = tmp_path / "ckpt"
    stale = tmp_path / f"ckpt{tckpt._TMP_TAG}999-1"
    stale.mkdir()
    (stale / "net.pkl").write_bytes(b"half a pickle")
    assert not tckpt.has_s3_ckpt(tmp_path)
    ck_dir.mkdir()
    assert not tckpt.has_s3_ckpt(tmp_path)
    (ck_dir / "net.orbax").mkdir()                          # an uncommitted orbax dir
    (ck_dir / "net.orbax" / "7.orbax-checkpoint-tmp-123").mkdir()
    assert not tckpt.has_s3_ckpt(tmp_path)

    tckpt.save_s3_ckpt(tmp_path, epoch=1, **_tree(1.0))
    assert tckpt.has_s3_ckpt(tmp_path)
    assert not list(tmp_path.glob(f"*{tckpt._TMP_TAG}*"))

    real = tckpt._JaxCheckpointPickler.dump

    def die_midway(self, obj):
        if isinstance(obj, dict) and "net_params" in obj:
            self.write(b"\x80\x04partial")
            raise OSError("the writer was killed")
        return real(self, obj)

    monkeypatch.setattr(tckpt._JaxCheckpointPickler, "dump", die_midway)
    tckpt.save_s3_ckpt(tmp_path, epoch=2, async_save=True, **_tree(2.0))
    with pytest.raises(RuntimeError, match="asynchronous checkpoint save failed"):
        tckpt.wait_for_saves()
    monkeypatch.setattr(tckpt._JaxCheckpointPickler, "dump", real)
    assert list(tmp_path.glob(f"ckpt{tckpt._TMP_TAG}*"))    # the killed writer's temporary
    ck = tckpt.load_s3_ckpt(tmp_path)
    assert ck["epoch"] == 1
    np.testing.assert_array_equal(ck["net_params"]["style_0"]["weight"], 1.0)

    tckpt.save_s3_ckpt(tmp_path, epoch=3, **_tree(3.0))
    assert not list(tmp_path.glob(f"*{tckpt._TMP_TAG}*"))
    assert tckpt.load_s3_ckpt(tmp_path)["epoch"] == 3


def _die_on_net(monkeypatch):
    """Kill the writer as it pickles ``net.pkl``, after ``optm.pkl`` and
    ``info.txt`` of the new epoch are written."""
    real = tckpt._JaxCheckpointPickler.dump

    def die(self, obj):
        if isinstance(obj, dict) and "net_params" in obj:
            raise OSError("the writer was killed")
        return real(self, obj)

    monkeypatch.setattr(tckpt._JaxCheckpointPickler, "dump", die)
    return real


def _assert_epoch_one(model_path):
    """The epoch-1 checkpoint whole: its net beside its own Adam state and
    iteration, as both packages read it."""
    ck = tckpt.load_s3_ckpt(model_path)
    assert ck["epoch"] == 1 and ck["iteration"] == 1
    np.testing.assert_array_equal(ck["net_params"]["style_0"]["weight"], 1.0)
    assert (model_path / "ckpt" / "info.txt").read_text() == "Epoch 1\n"
    jck = jckpt.load_s3_ckpt(model_path)
    assert jck["epoch"] == 1 and jck["iteration"] == 1


def test_writer_killed_between_files_keeps_the_whole_last_commit(tmp_path, monkeypatch):
    """A writer killed after the new ``optm.pkl`` but before the new
    ``net.pkl`` leaves the previous epoch's files together: no new Adam
    moments or iteration beside the old net."""
    tckpt.save_s3_ckpt(tmp_path, epoch=1, **_tree(1.0))
    real = _die_on_net(monkeypatch)
    with pytest.raises(OSError, match="killed"):
        tckpt.save_s3_ckpt(tmp_path, epoch=2, **_tree(2.0))
    monkeypatch.setattr(tckpt._JaxCheckpointPickler, "dump", real)
    _assert_epoch_one(tmp_path)


def test_swap_without_the_atomic_exchange(tmp_path, monkeypatch):
    """Where the file system has no atomic exchange, the swap is two renames;
    a writer cut between them leaves the previous checkpoint aside, and the
    next reader or save puts it back."""
    tckpt.save_s3_ckpt(tmp_path, epoch=1, **_tree(1.0))
    monkeypatch.setattr(tckpt, "_exchange", lambda a, b: False)
    real_rename = os.rename
    renames = []

    def cut_after_first(src, dst):
        renames.append((str(src), str(dst)))
        if len(renames) == 2:
            raise OSError("the writer was killed")
        real_rename(src, dst)

    monkeypatch.setattr(tckpt.os, "rename", cut_after_first)
    with pytest.raises(OSError, match="killed"):
        tckpt.save_s3_ckpt(tmp_path, epoch=2, **_tree(2.0))
    monkeypatch.setattr(tckpt.os, "rename", real_rename)
    assert not (tmp_path / "ckpt").exists()
    assert tckpt.has_s3_ckpt(tmp_path)
    _assert_epoch_one(tmp_path)
    tckpt.save_s3_ckpt(tmp_path, epoch=3, **_tree(3.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
    assert tckpt.load_s3_ckpt(tmp_path)["epoch"] == 3


def test_same_epoch_async_then_sync_resave(tmp_path, monkeypatch):
    """A mid-epoch async save, then the end-of-epoch sync save of the same
    epoch while the first may still be writing: the later one wins."""
    gate = threading.Event()
    real = tckpt._write_all

    def slow(path, files):
        gate.wait(10)
        real(path, files)

    monkeypatch.setattr(tckpt, "_write_all", slow)
    tckpt.save_s3_ckpt(tmp_path, epoch=1, async_save=True, **_tree(100.0))
    threading.Timer(0.2, gate.set).start()
    tckpt.save_s3_ckpt(tmp_path, epoch=1, **_tree(250.0))
    ck = tckpt.load_s3_ckpt(tmp_path)
    assert ck["epoch"] == 1 and ck["iteration"] == 250
    np.testing.assert_array_equal(ck["net_params"]["style_0"]["weight"], 250.0)
    tckpt.save_s3_ckpt(tmp_path, epoch=1, **_tree(300.0))
    assert tckpt.load_s3_ckpt(tmp_path)["iteration"] == 300


@pytest.mark.parametrize("async_save", [False, True])
def test_jax_package_loads_what_the_port_wrote(tmp_path, async_save):
    tree = _tree(5.0)
    tckpt.save_s3_ckpt(tmp_path, epoch=6, active_sh_degree=1, async_save=async_save, **tree)
    tckpt.wait_for_saves()
    ck = jckpt.load_s3_ckpt(tmp_path)
    assert ck["epoch"] == 6 and ck["activate_sh_degree"] == 1 and ck["iteration"] == 5
    assert isinstance(ck["splats"], JG.GaussianParams)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(ck["splats"], k)),
                                      getattr(tree["splats"], k))
    np.testing.assert_array_equal(np.asarray(ck["net_params"]["style_0"]["weight"]), 5.0)
    assert int(ck["net_adam"].step) == 3


def _jax_orbax_ckpt(model_path, epoch=4):
    """A stage-3 orbax checkpoint written by the JAX package, seeded leaves."""
    rng = np.random.RandomState(0)
    splats = JG.GaussianParams(**{k: jnp.asarray(rng.randn(*s).astype(np.float32))
                                  for k, s in SHAPES.items()})
    params = {"style_0": {"weight": jnp.asarray(rng.randn(3, 3).astype(np.float32)),
                          "bias": jnp.asarray(rng.randn(3).astype(np.float32))}}
    state = SimpleNamespace(
        net_params=params, net_buffers={"noise_0": jnp.asarray(rng.randn(1, 1, 4, 4)
                                                               .astype(np.float32))},
        splats=splats, net_adam=j_tree_adam_init(params), splat_adam=j_tree_adam_init(splats),
        iteration=jnp.int32(11))
    jckpt.save_s3_ckpt(model_path, state, epoch, active_sh_degree=2, backend="orbax")
    jckpt.wait_for_saves()
    return state


def test_orbax_refused_by_name_and_converted(tmp_path):
    src, out = tmp_path / "jax_run", tmp_path / "converted"
    state = _jax_orbax_ckpt(src)
    assert tckpt.has_s3_ckpt(src)
    with pytest.raises(NotImplementedError, match="orbax_to_pickle.py"):
        tckpt.load_s3_ckpt(src)

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import orbax_to_pickle
    finally:
        sys.path.pop(0)
    orbax_to_pickle.convert(src, out)
    ck = tckpt.load_s3_ckpt(out)
    assert ck["epoch"] == 4 and ck["activate_sh_degree"] == 2 and ck["iteration"] == 11
    assert isinstance(ck["splats"], GaussianParams)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(ck["splats"], k),
                                      np.asarray(getattr(state.splats, k)))
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(ck["net_params"]["style_0"][k],
                                      np.asarray(state.net_params["style_0"][k]))
    np.testing.assert_array_equal(ck["net_buffers"]["noise_0"],
                                  np.asarray(state.net_buffers["noise_0"]))
    assert isinstance(ck["net_adam"], TreeAdam) and isinstance(ck["splat_adam"], TreeAdam)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(ck["splat_adam"].mu, k),
                                      np.asarray(getattr(state.splat_adam.mu, k)))
    # the port's state converter takes it
    s3 = tckpt.s3_state_from_jax(ck, device="cpu")
    torch.testing.assert_close(s3.splats.xyz, torch.from_numpy(np.array(state.splats.xyz)),
                               rtol=0, atol=0)
