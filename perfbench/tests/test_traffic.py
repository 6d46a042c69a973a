"""The inputs each cell's traffic makes: the same seed gives the same
inputs, another seed other inputs, and the checked steps use rows that all
differ."""
import json

import pytest
import torch

from perfbench.harness.bench import load_cell, load_module
from perfbench.tests import tiny

CELLS = tiny.cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("traffic"))


def _inputs(root, cell, seed):
    c = load_cell(cell + ".tiny", root)
    mod = load_module(root / "perfbench/entries" / f"{c.traffic['entry']}.py")
    return mod.make_inputs(c.cfg, c.traffic, seed, torch.device("cpu"))


def _tensors(x, prefix=""):
    """Every tensor and array reachable in ``x``, by path."""
    out = {}
    if isinstance(x, torch.Tensor):
        out[prefix] = x
    elif hasattr(x, "__array__") and not isinstance(x, (int, float)):
        out[prefix] = torch.as_tensor(x)
    elif isinstance(x, dict):
        for k, v in x.items():
            out.update(_tensors(v, f"{prefix}.{k}"))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            out.update(_tensors(v, f"{prefix}[{i}]"))
    elif hasattr(x, "__dict__"):
        out.update(_tensors(vars(x), prefix))
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(root, cell):
    seed = 2 ** 31 + 12345
    a, b = _tensors(_inputs(root, cell, seed)), _tensors(_inputs(root, cell, seed))
    assert a.keys() == b.keys() and len(a) > 5
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_other_inputs(root, cell):
    a, b = _tensors(_inputs(root, cell, 1)), _tensors(_inputs(root, cell, 2))
    differ = [k for k in a if a[k].shape != b[k].shape or not torch.equal(a[k], b[k])]
    assert len(differ) >= 3


def test_checked_steps_use_different_rows(root):
    """The first three steps of every cell draw different items or camera
    sets (the reference follows them)."""
    for cell in CELLS:
        inp = _inputs(root, cell, 99)
        rows = inp.order[:3] if hasattr(inp, "order") else [tuple(c) for c in inp.cams[:3]]
        assert len(set(rows)) == 3, cell


def test_traffic_files_hold_parameters_only():
    for cell in CELLS:
        c = load_cell(cell)
        assert all(isinstance(v, (int, float, str, list)) for v in c.traffic.values())
        json.dumps(c.traffic)
