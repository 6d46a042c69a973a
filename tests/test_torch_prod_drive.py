"""The port's production drive (``gaussian_garments_tpu_torch/prod_drive.py``)
against ``scripts/prod_drive.py`` and the JAX package.

- The drive end to end on the CPU at a tiny size (3 cameras at 48², 2
  frames, nx 6, texture 32, a few iterations; the drive's fixed SH 3 and
  940×1280 inference frame), split over two "calls"
  as on the card: the first runs the dataset and stage 2 and carries stage 2's
  output out, the second starts from an empty root, rebuilds the dataset and
  runs s3 (killed at its first committed checkpoint, then resumed), both
  eval-only legs and inference. Its summary holds every key the JAX drive's
  summary holds, less what the port does not copy (the stall watchdog's and
  the timed kill's settings, and the notes added by hand).
- ``write_reference_layout`` of both packages on the same arguments:
  ``cameras.json`` within 1e-6, meshes, UVs, bodies and the planted
  ``point_cloud.ply`` equal; RGB within 2/255 and masks equal at 99.9% of
  the pixels (the JAX writer renders with its exact oracle at this size, the
  port with its tiled compositor, whose float32 sums differ in order).
- ``tail_jsonl`` and the stage-2 harvest against ``scripts/prod_drive.py``'s
  on the same logs; the JAX script is loaded from its path, and its module
  level imports no JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gaussian_garments_tpu.data.synthetic import write_reference_layout as jax_layout
from gaussian_garments_tpu_torch import prod_drive as PD
from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout as torch_layout
from gaussian_garments_tpu_torch.utils.io import fetch_ply, read_obj, read_ply

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--cams", "3", "--res", "48", "--frames", "2", "--nx", "6",
        "--texture", "32", "--tmpl_iters", "6", "--tmpl_coll", "2", "--frame_iters", "3",
        "--frame_coll", "1", "--save_iterations", "1"]
# what the port does not copy: the stall watchdog, the timed kill (the port's
# kill is an event), and the notes written into the JAX summary by hand
NOT_COPIED = {"r5_notes", "config.stall_s", "config.s3_interrupt_s"}


def _drive(*argv):
    """The drive in a new process, as a user runs it (this test process has
    jax imported, which the drive refuses)."""
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                         if p)}
    return subprocess.run([sys.executable, "-m", "gaussian_garments_tpu_torch.prod_drive",
                           *TINY, *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("config",):
            out |= _keys(v, prefix + k + ".")
    return out


def test_drive_end_to_end_over_two_calls(tmp_path):
    first, second = tmp_path / "call1", tmp_path / "call2"
    carry = tmp_path / "carry.tgz"
    r = _drive("--root", str(first), "--call", "c1", "--until", "s2_sequence",
               "--carry_out", str(carry))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    r = _drive("--root", str(second), "--call", "c2", "--from", "s3", "--carry_in", str(carry))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    summary = json.loads((second / "prod_drive_summary.json").read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == summary

    # the calls: the second root was empty, stage 2 came from the tarball
    assert summary["calls"]["c1"]["legs"] == ["dataset", "s2_template", "s2_sequence"]
    assert summary["calls"]["c2"]["root_at_start"] == []
    assert summary["calls"]["c2"]["legs"] == ["dataset", "s3", "eval_f32", "eval_bf16",
                                              "inference"]
    legs = summary["legs"]
    assert {k: v["call"] for k, v in legs.items()} == {
        "dataset": "c2", "s2_template": "c1", "s2_sequence": "c1", "s3_first": "c2",
        "s3_resume": "c2", "eval_f32": "c2", "eval_bf16": "c2", "inference": "c2"}
    assert all(v["card"] == "cpu" for v in legs.values())
    assert all(v.get("foreign_modules") == [] for k, v in legs.items() if k != "s3_first")
    assert summary["foreign_modules"] == []

    # the dataset is rebuilt bit for bit
    for sub in ("data", "out/subj/stage1"):
        files = sorted(p.relative_to(first) for p in (first / sub).rglob("*") if p.is_file())
        assert files
        for f in files:
            assert (first / f).read_bytes() == (second / f).read_bytes(), f

    # every leg's artifacts
    s2, s3 = second / "out/subj/stage2", second / "out/subj/stage3"
    for f in ("template.obj", "local_point_cloud.ply", "point_cloud.ply", "binding.pkl"):
        assert (s2 / "Template" / f).exists()
    for t in range(2):
        assert (s2 / "seq1/meshes" / f"frame_{t:05d}.obj").exists()
        assert (s2 / "seq1/point_cloud" / f"frame_{t:05d}/point_cloud.ply").exists()
    for f in ("net.pkl", "optm.pkl", "info.txt"):
        assert (s3 / "ckpt" / f).exists()
    assert (s3 / "ckpt/info.txt").read_text().strip() == "Epoch 5"
    assert summary["s3_final_info"] == "Epoch 5"

    # the event kill, then the resume
    assert summary["s3_interrupted"] is True
    assert 1 <= summary["s3_kill_epoch"] <= 4
    k = int(summary["s3_resumed_from"].split()[-1])
    assert summary["s3_resumed_from"] == f"Resumed from epoch {k}" and 1 <= k <= 4
    assert "Resumed from epoch" in (second / "logs/s3_resume.log").read_text()
    assert summary["s3_eval"]["epoch"] == 5.0 and np.isfinite(summary["s3_eval"]["eval_psnr"])

    # both EVAL_ONLY lines
    for tag in ("f32", "bf16"):
        lines = [line for line in (second / f"logs/eval_{tag}.log").read_text().splitlines()
                 if line.startswith("EVAL_ONLY ")]
        assert len(lines) == 1
        assert json.loads(lines[0][len("EVAL_ONLY "):]) == summary["unet_bf16_delta"][tag]
        assert np.isfinite(summary["unet_bf16_delta"][tag]["eval_psnr"])

    # inference
    assert summary["inference_frames"] == 2
    assert len(list((second / "render_out/renders").glob("*.png"))) == 2
    assert set(summary["inference_split"]) == {"bake_mesh_io_s", "render_s", "png_s"}

    # the JAX drive's keys
    jax_summary = json.loads((REPO / "prod_drive_summary.json").read_text())
    assert _keys(jax_summary) - NOT_COPIED <= _keys(summary)
    assert set(summary["s2_frame_quality"]) == {"frame_00000", "frame_00001"}
    for row in summary["s2_frame_quality"].values():
        assert set(row) == set(jax_summary["s2_frame_quality"]["frame_00000"])
        assert all(np.isfinite(v) for v in row.values())


def test_drive_stops_on_a_missing_leg(tmp_path):
    """``--from s3`` on a root without stage 2 fails, after rebuilding the
    dataset, with a non-zero exit."""
    r = _drive("--root", str(tmp_path), "--from", "s3", "--until", "s3")
    assert r.returncode != 0
    assert "s2_template has not run" in r.stderr
    assert not (tmp_path / "out/subj/stage3").exists()


def test_drive_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.main(["--root", "unused"])


def _png(path):
    return np.asarray(Image.open(path), np.int16)


def test_write_reference_layout_matches_jax(tmp_path):
    kw = dict(n_cams=4, n_frames=2, nx=8, ny=8, res=64)
    jax_layout(tmp_path / "jd", tmp_path / "jo", "subj", "seq1", **kw)
    torch_layout(tmp_path / "td", tmp_path / "to", "subj", "seq1", device="cpu", **kw)
    jd, td = tmp_path / "jd/subj/seq1", tmp_path / "td/subj/seq1"
    for a, b in ((jd / "cameras.json", td / "cameras.json"),
                 (tmp_path / "jo/subj/stage1/cameras.json",
                  tmp_path / "to/subj/stage1/cameras.json")):
        ja, tb = json.loads(a.read_text()), json.loads(b.read_text())
        assert ja.keys() == tb.keys()
        for cam in ja:
            assert ja[cam]["ids"] == tb[cam]["ids"]
            for key in ("intrinsics", "extrinsics"):
                np.testing.assert_allclose(tb[cam][key], ja[cam][key], rtol=0, atol=1e-6)

    jm, tm = (read_obj(tmp_path / f"{p}o/subj/stage1/template_uv.obj") for p in "jt")
    for key in ("vertices", "faces", "uvs", "texture_faces"):
        np.testing.assert_array_equal(tm[key], jm[key])
    jp, tp = (fetch_ply(tmp_path / f"{p}o/subj/stage1/point_cloud.ply") for p in "jt")
    np.testing.assert_array_equal(tp.points, jp.points)
    np.testing.assert_array_equal(tp.colors, jp.colors)
    for t in range(2):
        jb, tb = (read_ply(d / "smplx" / f"{t:05d}.ply") for d in (jd, td))
        assert jb.keys() == tb.keys()
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])

    rgb_off, mask_off, n_rgb, n_mask = 0, 0, 0, 0
    for cam in range(4):
        for t in range(2):
            ja, tb = (_png(d / f"Cam{cam:03d}/rgb_images/{t:05d}.png") for d in (jd, td))
            assert ja.shape == tb.shape == (64, 64, 3)
            rgb_off += int((np.abs(tb - ja) > 2).any(-1).sum())
            n_rgb += 64 * 64
            for sub in ("garment_masks", "foreground_masks"):
                ja, tb = (_png(d / f"Cam{cam:03d}/{sub}/{t:05d}.png") for d in (jd, td))
                mask_off += int((ja != tb).sum())
                n_mask += ja.size
            assert _png(jd / f"Cam{cam:03d}/garment_masks/{t:05d}.png").any()
    assert rgb_off <= 0.001 * n_rgb, f"{rgb_off} of {n_rgb} pixels off by more than 2/255"
    assert mask_off <= 0.001 * n_mask, f"{mask_off} of {n_mask} mask pixels differ"


def _jax_drive_module():
    spec = importlib.util.spec_from_file_location("jax_prod_drive",
                                                  REPO / "scripts" / "prod_drive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _StopAfterS2(Exception):
    pass


def _write_logs(log_dir: Path, rng):
    """Per-frame stage-2 logs as both drivers write them: loss lines, a
    densification line, a malformed line, then the save point's quality."""
    log_dir.mkdir(parents=True)
    for t in range(3):
        lines = []
        for step in (1, 100, 200):
            lines.append(json.dumps({"step": step, "img": float(rng.rand()),
                                     "ssim": float(rng.rand()), "n_splats": 50.0,
                                     "time": 1.0}))
        lines.append(json.dumps({"step": 150, "n_clone": 3.0, "grad_mean": 1e-8}))
        lines.append("{not json")
        q = {f"{split}_{k}": float(rng.rand() * 40) for split in ("train", "test")
             for k in ("psnr", "ssim", "psnr_masked", "ssim_masked")}
        lines.append(json.dumps({"step": 200, **q, "frame": float(t), "time": 2.0}))
        if t == 1:   # a frame with no quality line and an int metric
            lines = lines[:3] + [json.dumps({"step": 300, "test_psnr": 30})]
        (log_dir / f"frame_{t:05d}.jsonl").write_text("\n".join(lines) + "\n")


def test_tail_jsonl_and_harvest_match_the_jax_drive(tmp_path, monkeypatch, capsys):
    mod = _jax_drive_module()
    root = tmp_path / "root"
    s2 = root / "out/subj/stage2"
    _write_logs(s2 / "seq1/logs", np.random.RandomState(0))
    keys = ("test_psnr", "test_ssim", "ssim", "n_clone", "missing")
    for f in sorted((s2 / "seq1/logs").glob("*.jsonl")):
        assert PD.tail_jsonl(f, keys) == mod.tail_jsonl(f, keys)
    assert PD.tail_jsonl(tmp_path / "none.jsonl", keys) == mod.tail_jsonl(
        tmp_path / "none.jsonl", keys) == {}

    # the JAX drive's harvest is inline in its main(): run main() with the
    # stage-2 legs' artifacts present and stop it where stage 3 starts
    (s2 / "Template").mkdir(parents=True)
    (s2 / "Template/local_point_cloud.ply").touch()
    (s2 / "seq1/meshes").mkdir(parents=True)
    (s2 / "seq1/meshes/frame_00002.obj").touch()

    def stop(*a, **k):
        raise _StopAfterS2

    monkeypatch.setattr(mod, "ROOT", root)
    monkeypatch.setattr(mod, "ensure_dataset", lambda *a: 0.0)
    monkeypatch.setattr(mod, "run_stage", stop)
    monkeypatch.setattr(mod.subprocess, "run", stop)
    monkeypatch.setattr(sys, "argv", ["prod_drive.py", "--frames", "3"])
    capsys.readouterr()
    with pytest.raises(_StopAfterS2):
        mod.main()
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"s2"')]
    assert len(lines) == 1
    want = lines[0]["s2"]
    assert PD.harvest_s2_quality(s2 / "seq1/logs") == want
    assert set(want) == {"frame_00000", "frame_00001", "frame_00002"}
    assert "ssim_loss_term" in want["frame_00000"] and "ssim" not in want["frame_00000"]
