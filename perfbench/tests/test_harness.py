"""The harness end to end on tiny CPU copies of every cell: the result
line, the traced line, a step broken underneath, a cell and a metric added
as files only, and the runs that must print nothing."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.tests import tiny

CELLS = tiny.cells()
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


def _line(lines):
    return json.loads(lines[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "3000000019",
                                   "--seconds", "1", "--trace", "0"])
    assert rc == 0, err
    r = _line(out)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell + ".tiny" in m.get("workloads", [
        cell + ".tiny"])}
    assert set(r["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = json.loads((root / "perfbench/limits" / f"{cell}.tiny.json").read_text())
    assert {k: v["limit"] for k, v in r["checks"].items()} == limits
    # each compared number is also a last line of standard error
    tail = err.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "7", "--seconds", "1",
                                   "--trace", "1"])
    assert rc == 0, err
    r = _line(out)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    # the CPU has no device kernels: the readers of kernel shares find nothing
    assert not any("roofline" in k for k in r["metrics"])


def _unchanged(step):
    """A step that returns the state it was given."""
    def broken(state, *args):
        _, *rest = step(state, *args)
        return (state, *rest)
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "11", "--seconds",
                                   "1", "--trace", "0"], fault=_unchanged)
    assert rc == 0, err
    r = _line(out)
    assert r["correct"] is False
    assert r["checks"]["change_median"]["value"] > r["checks"]["change_median"]["limit"]


def _splats_untrained(step):
    """A step that trains the net and leaves the texel splats and their
    optimizer state as they were, as ``train_gaussians=False`` does."""
    def broken(state, *args):
        new, *rest = step(state, *args)
        return (new.replace(splats=state.splats, splat_adam=state.splat_adam), *rest)
    return broken


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("s3_")])
def test_splats_left_untrained_is_not_correct(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "13", "--seconds",
                                   "1", "--trace", "0"], fault=_splats_untrained)
    assert rc == 0, err
    r = _line(out)
    assert r["correct"] is False
    assert r["checks"]["grad_splats"]["value"] > r["checks"]["grad_splats"]["limit"]


def _half_batch(step):
    """A step that renders the first half of its cameras and takes the mean
    over them."""
    import dataclasses

    def broken(state, cams, *args):
        k = cams.world_view.shape[0] // 2
        cut = {f.name: getattr(cams, f.name)[:k] for f in dataclasses.fields(cams)
               if f.name in ("world_view", "full_proj", "campos", "image", "mask", "tanfovx",
                             "tanfovy")}
        return step(state, dataclasses.replace(cams, **cut), *args)
    return broken


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("s2_")])
def test_half_batch_is_not_correct(root, cell):
    rc, out, err = tiny.run(root, ["--workload", cell + ".tiny", "--seed", "12", "--seconds",
                                   "1", "--trace", "0"], fault=_half_batch)
    assert rc == 0, err
    assert _line(out)["correct"] is False


def test_cell_and_metric_added_as_files(root, tmp_path):
    """A new traffic mix, limits and per-layer metric, added as new files and
    named in BENCHMARK.json, are run and read with no edit to any file of
    ``perfbench/``."""
    base = CELLS[0] + ".tiny"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == base)
    t = json.loads((root / "perfbench/traffic" / f"{cell['traffic']}.json").read_text())
    t["warmup_steps"] = t["warmup_steps"] + 1
    (root / "perfbench/traffic/added.json").write_text(json.dumps(t))
    (root / "perfbench/limits/added.cell.json").write_text(
        (root / "perfbench/limits" / f"{base}.json").read_text())
    (root / "perfbench/metrics/steps_traced.added.py").write_text(
        '"""Steps in the traced window."""\n\n\ndef read(run):\n    return run.steps\n')
    bench["workloads"].append({**cell, "name": "added.cell", "traffic": "added"})
    for m in bench["end_to_end"]:
        if "workloads" in m and base in m["workloads"]:
            m["workloads"].append("added.cell")
    bench["per_layer"].append({"name": "steps_traced.added", "unit": "step", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": bench["end_to_end"][0]["name"],
                               "workloads": ["added.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = tiny.run(root, ["--workload", "added.cell", "--seed", "5", "--seconds", "1",
                                   "--trace", "1"])
    assert rc == 0, err
    assert _line(out)["metrics"]["steps_traced.added"]["value"] == t["trace_steps"]


def test_no_jax_in_any_cell(tmp_path):
    """Every cell's run, in a fresh process, loads no module of JAX or of the
    JAX package (whole top-level names)."""
    root = tiny.checkout(tmp_path)
    code = ("import sys; sys.path.insert(0, %r); from perfbench.tests import tiny\n"
            "from perfbench.harness.bench import forbidden_modules\n"
            "from pathlib import Path\n"
            "for c in tiny.cells():\n"
            "    rc, out, err = tiny.run(Path(%r), ['--workload', c + '.tiny', '--seed', '1',"
            " '--seconds', '1', '--trace', '0'])\n"
            "    assert rc == 0, err\n"
            "print('FOUND', forbidden_modules())\n") % (str(tiny.REPO), str(root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FOUND []"


def test_forbidden_names_are_whole():
    from perfbench.harness import bench

    sys.modules.setdefault("gaussian_garments_tpu_torch_probe_name", sys)
    try:
        assert "gaussian_garments_tpu" not in bench.forbidden_modules()
    finally:
        del sys.modules["gaussian_garments_tpu_torch_probe_name"]


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_prints_nothing_without_a_card_or_the_program(tmp_path, only_benchmark):
    """Without CUDA (and, in a directory of BENCHMARK.json and perfbench/
    alone, without the program) a run exits non-zero and prints no line."""
    cwd = tiny.REPO
    if only_benchmark:
        cwd = tmp_path / "bare"
        import shutil
        shutil.copytree(tiny.REPO / "perfbench", cwd / "perfbench")
        shutil.copy(tiny.REPO / "BENCHMARK.json", cwd / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                        "4294967311", "--seconds", "1", "--trace", "0"], cwd=cwd,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
