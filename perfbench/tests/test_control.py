"""The control of each cell: the reference put in the program's place and
computed in TF32 (the precision below the configurations' float32 with TF32
off) has to come out as not correct; on the CPU at the tiny size, and on the
card at the cell's own size (``perfbench/calibrate.py --control`` reads it
on many seeds there)."""
import pytest
import torch

from perfbench.harness.bench import load_cell, make_entry
from perfbench.tests import tiny


def _control_fails(cell, device, seed):
    entry = make_entry(cell, seed, device)
    entry.traffic = {**entry.traffic, "warmup_steps": 0}
    entry.setup()
    entry.close()
    control = entry.check(entry.reference(), entry.reference(tf32=True))
    return [k for k, limit in cell.limits.items() if control[k][0] > limit], control


@pytest.mark.parametrize("cell", tiny.cells())
def test_control_is_not_correct_tiny(tmp_path, cell):
    torch.set_num_threads(4)
    c = load_cell(cell + ".tiny", tiny.checkout(tmp_path))
    failed, control = _control_fails(c, torch.device("cpu"), 4000000001)
    assert failed, control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.cells())
def test_control_is_not_correct(card, cell):
    failed, control = _control_fails(load_cell(cell), card, 4000000001)
    assert failed, control
