"""The readers of the program's spans and counters (``harness/spans.py``): on
a made-up trace and records, the alignment, the self times, the counts and
the split of the device's idle time; with a program that records nothing,
no value; on the tiny CPU cells, every such metric in the traced line."""
import json
from types import SimpleNamespace

import pytest

from perfbench.harness import spans
from perfbench.harness.trace import Trace
from perfbench.tests import tiny

OFFSET_US = 5_000_000.0     # record clock − trace clock


class Program:
    """The program's recorder as ``spans`` reads it: records in ns on a clock
    ``OFFSET_US`` ahead of the trace's, and per-step counts."""

    def __init__(self, rows, counts):
        from gaussian_garments_tpu_torch.utils import logging as L

        self.rows, self.counts, self._L = rows, counts, L

    def records(self):
        ns = lambda us: int((us + OFFSET_US) * 1e3)
        return [self._L.Record(n, p, s, ns(a), ns(b)) for n, p, s, a, b in self.rows]

    def self_times(self, recs, steps):
        return self._L.self_times(recs, steps)

    def counters(self, step=None):
        return self.counts[step]


# two steps of 100 µs; the harness's step spans hold the program's
TRACE = Trace(start=0.0, end=220.0,
              device=[(20.0, 30.0, "k"), (60.0, 95.0, "k"), (130.0, 200.0, "k")],
              spans=[(0.0, 100.0, "step"), (5.0, 95.0, "step"),
                     (110.0, 220.0, "step"), (115.0, 205.0, "step")],
              host_ops=[])
ROWS = [("step", -1, 0, 5.0, 95.0), ("project", 0, 0, 10.0, 50.0), ("sync", 1, 0, 40.0, 50.0),
        ("loss", 0, 0, 60.0, 90.0),
        ("step", -1, 1, 115.0, 205.0), ("project", 4, 1, 120.0, 160.0),
        ("loss", 4, 1, 170.0, 200.0)]


@pytest.fixture
def run(monkeypatch):
    prog = Program(ROWS, {0: {"host_syncs": 3}, 1: {"host_syncs": 1}})
    monkeypatch.setattr(spans, "_port", lambda: prog)
    return SimpleNamespace(trace=TRACE)


def test_records_align_and_add_up(run):
    w = spans.window(run)
    assert w.steps == {0, 1} and w.offsets == [OFFSET_US, OFFSET_US]
    s = spans.self_ms(run)
    assert s == pytest.approx({"step": (20 + 20) / 2e3, "project": (30 + 40) / 2e3,
                               "sync": 10 / 2e3, "loss": (30 + 30) / 2e3})
    assert sum(s.values()) == pytest.approx(90e-3)
    assert spans.count_per_step(run, "host_syncs") == 2.0
    assert spans.ms_per_step(run, "bin") is None


def test_idle_split_among_innermost_spans(run):
    # idle: [0,20) [30,60) [95,130) [200,220)
    d = spans.idle_ms(run)
    want = {"-": 5 + 20 + 15, "step": 5 + 10 + 5 + 5, "project": 10 + 10 + 10, "sync": 10}
    assert {k: v for k, v in d.items() if v} == pytest.approx(
        {k: v / 2e3 for k, v in want.items()})
    assert sum(d.values()) == pytest.approx((20 + 30 + 35 + 20) / 2e3)
    assert spans.idle_unspanned_pct(run) == pytest.approx(100 * 65 / 105)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_port", lambda: None)
    run = SimpleNamespace(trace=TRACE)
    assert spans.self_ms(run) is None
    assert spans.count_per_step(run, "host_syncs") is None
    assert spans.idle_unspanned_pct(run) is None
    assert spans.ms_per_step(SimpleNamespace(trace=None), "project") is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", tiny.cells())
def test_traced_line_has_every_span_metric(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "3000000021",
                                   "--seconds", "1", "--trace", "1"])
    assert rc == 0, err
    got = json.loads(out[-1])["metrics"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if cell + ".tiny" in m["workloads"] and m["name"].split(".")[0] in (
                "projection_ms", "binning_ms", "sync_wait_ms", "host_syncs_per_step", "loss_ms",
                "backward_ms", "adam_ms", "bundle_ms", "energies_ms", "unet_ms", "texels_ms",
                "idle_unspanned_pct")}
    assert len(want) == 10
    assert want <= set(got)
    assert all(got[k]["value"] >= 0 for k in want)
