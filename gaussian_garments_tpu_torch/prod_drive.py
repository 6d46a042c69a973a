"""The production drive: the whole pipeline at production scale as one
composed run, on the card.

Counterpart of ``scripts/prod_drive.py``. It drives the port's own CLI
drivers at the JAX drive's configuration and writes
``<root>/prod_drive_summary.json`` with the JAX summary's keys, so that the two
summaries compare line by line. The legs, in order:

- ``dataset``: ``data.synthetic.write_reference_layout`` (12 cameras at 1024²,
  8 frames, a 48×48 sheet), its ground truth rendered on the drive's device;
  deterministic, so a later call rebuilds it bit for bit;
- ``s2_template``: ``s2_registration -tf 0``, 3,000 + 600 iterations;
- ``s2_sequence``: ``s2_registration -t Template --eval``, 2,400 iterations on
  the first frame and 1,200 on each other, 240 with the body; its plateau
  stops are counted and its per-frame logs harvested;
- ``s3``: ``s3_appearance`` at texture 512, SH 3, ``--ckpt_backend orbax
  --save_iterations 40 --eval_items 6``, killed (SIGKILL) as soon as its first
  checkpoint is committed, while epochs remain, then resumed to "Epoch 5";
- ``eval_f32``, ``eval_bf16``: the same flags with ``--eval_only``, and with
  ``--unet_bf16``;
- ``inference``: the registered meshes as a trajectory, rendered at 940×1280.

    python -m gaussian_garments_tpu_torch.prod_drive [--root DIR] [--device cuda]
        [--from LEG] [--until LEG] [--call NAME] [--carry_in TAR] [--carry_out TAR]
        [--fresh] [--frames 8 --cams 12 --res 1024 --nx 48 ...]

Every leg runs in a child process, ``python -m
gaussian_garments_tpu_torch.prod_drive --leg DRIVER -- ARGV``, which calls the
driver's ``main(argv)`` and prints one line ``PROD_LEG {json}``: the stats
``main`` returned, the launches of the two compositor kernels
(``tiles.composite_tiles_cuda``, ``tiles.composite_tiles_backward_cuda``) and
the modules of jax, flax, orbax or ``gaussian_garments_tpu`` it imported. On
the card every leg that renders must launch the forward kernel, every leg
that trains the backward one too, and no leg may import any of those modules.

A leg whose artifacts exist is skipped. A leg that fails, outlasts its time
limit or leaves an expected artifact missing stops the drive with an error:
there is no retry and no fallback. ``--from``/``--until`` run a range of the
legs, so that the drive can be split over several machines: ``--carry_out``
packs stage 2's output, the summary and the logs into a tarball, and
``--carry_in`` unpacks one into the root of the next call, where the dataset
is rebuilt rather than carried. The summary records, for each leg, the call
(``--call``) and the card (``nvidia-smi`` name and power limit) it ran on.

``--device`` defaults to ``cuda`` and raises without a GPU; only ``--device
cpu`` runs the drive on the CPU.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tarfile
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parent.parent
LEGS = ("dataset", "s2_template", "s2_sequence", "s3", "eval_f32", "eval_bf16", "inference")
# each child's time limit, s; the s3 leg's two children each have its limit
LEG_TIMEOUT = {"dataset": 1800, "s2_template": 3600, "s2_sequence": 7200, "s3": 3600,
               "eval_f32": 1800, "eval_bf16": 1800, "inference": 1800}
FOREIGN = ("jax", "jaxlib", "flax", "orbax", "gaussian_garments_tpu")
SUBJECT, SEQUENCE = "subj", "seq1"
CONFIG_KEYS = ("frames", "cams", "res", "nx", "tmpl_iters", "tmpl_coll", "frame_iters",
               "frame_coll", "texture", "save_iterations", "device")
# fixed, as in the JAX drive: s3's held-out items an eval, its SH degree, and
# the inference frame (width, height)
EVAL_ITEMS, SH_DEGREE, WIDTH, HEIGHT = 6, 3, 940, 1280


def tail_jsonl(path: Path, keys):
    """Last observed value of each key across a JSONL log."""
    out = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        for k in keys:
            if k in d:
                out[k] = d[k]
    return out


def harvest_s2_quality(log_dir: Path) -> dict:
    """{frame log stem: quality} from stage 2's per-frame logs: the last test
    and train-probe metrics of each frame, rounded to 3 places. The log's
    ``ssim`` key is the loss term ``1 - λ·ssim``, not a frame SSIM, so it is
    renamed ``ssim_loss_term``."""
    frames_q = {}
    for f in sorted(Path(log_dir).glob("frame_*.jsonl")):
        q = tail_jsonl(f, ("test_psnr", "test_ssim", "test_ssim_masked",
                           "test_psnr_masked", "psnr", "ssim"))
        row = {k: round(v, 3) for k, v in q.items() if isinstance(v, (int, float))}
        if "ssim" in row:
            row["ssim_loss_term"] = row.pop("ssim")
        frames_q[f.stem] = row
    return frames_q


def foreign_modules() -> list:
    """The imported modules of jax, flax, orbax or the JAX package."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or "cpu"."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "cpu"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "cpu"


# ---------------------------------------------------------------- the child


def dataset_main(argv: Sequence[str]) -> dict:
    """The dataset leg: ``write_reference_layout`` at the given size."""
    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.data.synthetic import write_reference_layout

    ap = ArgumentParser()
    for name in ("--data", "--out", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--cams", "--frames", "--nx", "--res"):
        ap.add_argument(name, type=int, required=True)
    a = ap.parse_args(list(argv))
    info = write_reference_layout(a.data, a.out, SUBJECT, SEQUENCE, n_cams=a.cams,
                                  n_frames=a.frames, nx=a.nx, ny=a.nx, res=a.res,
                                  device=resolve_device(a.device))
    return {"faces": int(len(info["faces"])), "fx": info["fx"],
            "min_coverage": info["min_coverage"]}


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.generic,)):
        return x.item()
    return x if isinstance(x, (int, float, str, bool, type(None))) else str(x)


def run_child(driver: str, argv: Sequence[str]) -> int:
    """One leg in this process: ``driver``'s ``main(argv)``, then the
    ``PROD_LEG`` line."""
    import importlib

    from gaussian_garments_tpu_torch.ops import tiles

    fn = dataset_main if driver == "dataset" else \
        importlib.import_module(f"gaussian_garments_tpu_torch.{driver}").main
    t0 = time.perf_counter()
    stats = fn(list(argv))
    report = {"driver": driver, "seconds": time.perf_counter() - t0,
              "launches": tiles.launches(),
              "foreign_modules": foreign_modules(), "stats": _jsonable(stats)}
    print("PROD_LEG " + json.dumps(report), flush=True)
    return 0


# --------------------------------------------------------------- the parent


class LegFailed(RuntimeError):
    pass


class Drive:
    def __init__(self, args):
        self.args = args
        self.root = Path(args.root).resolve()
        self.data = self.root / "data"
        self.out = self.root / "out"
        self.subj = self.out / SUBJECT
        self.s2 = self.subj / "stage2"
        self.s3 = self.subj / "stage3"
        self.logs = self.root / "logs"
        self.summary_path = self.root / "prod_drive_summary.json"
        self.card = card_line() if args.device != "cpu" else "cpu"
        path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)
        self.env = {**os.environ, "PYTHONPATH": path, "PYTHONUNBUFFERED": "1",
                    "GG_DATA_ROOT": str(self.data), "GG_OUTPUT_ROOT": str(self.out),
                    "GG_AUX_ROOT": str(self.root / "aux"),
                    "GG_TEMP_FOLDER": str(self.root / "tmp")}
        self.summary = {}

    # -- bookkeeping
    def config(self) -> dict:
        return {k: getattr(self.args, k) for k in CONFIG_KEYS}

    def save(self) -> None:
        self.summary_path.write_text(json.dumps(self.summary, indent=2))

    def marker(self) -> Path:
        a = self.args
        return self.data / SUBJECT / SEQUENCE / f"done_{a.frames}_{a.cams}_{a.res}_{a.nx}"

    def done(self, leg: str) -> bool:
        a = self.args
        if leg == "dataset":
            return self.marker().exists()
        if leg == "s2_template":
            return (self.s2 / "Template" / "local_point_cloud.ply").exists()
        if leg == "s2_sequence":
            return (self.s2 / SEQUENCE / "meshes" / f"frame_{a.frames - 1:05d}.obj").exists()
        if leg == "s3":
            return self.s3_epoch() == 5
        if leg in ("eval_f32", "eval_bf16"):
            return leg[5:] in self.summary.get("unet_bf16_delta", {})
        if leg == "inference":
            return len(list((self.root / "render_out" / "renders").glob("*.png"))) >= a.frames
        raise KeyError(leg)

    def s3_epoch(self) -> Optional[int]:
        """The epoch of the committed checkpoint in ``stage3/ckpt``, or None.
        Only reads: a live writer may be committing beside it."""
        info = self.s3 / "ckpt" / "info.txt"
        try:
            text = info.read_text().strip()
        except OSError:
            return None
        if not (self.s3 / "ckpt" / "net.pkl").exists() or not text.startswith("Epoch "):
            return None
        return int(text.split()[1])

    # -- children
    def spawn(self, name: str, driver: str, argv: Sequence[str]):
        self.logs.mkdir(parents=True, exist_ok=True)
        log = self.logs / f"{name}.log"
        cmd = [sys.executable, "-m", "gaussian_garments_tpu_torch.prod_drive", "--leg", driver,
               "--", *map(str, argv)]
        print(f"[prod_drive] {name}: {' '.join(cmd[1:])}", flush=True)
        fh = open(log, "w")
        proc = subprocess.Popen(cmd, cwd=REPO, env=self.env, stdout=fh, stderr=subprocess.STDOUT,
                                start_new_session=True)
        return proc, fh, log

    @staticmethod
    def kill(proc) -> None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()

    def finish(self, name, proc, fh, log, t0, timeout_s) -> tuple:
        """Wait for a child; return (wall s, its output, its report)."""
        try:
            rc = proc.wait(timeout=max(timeout_s - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            self.kill(proc)
            fh.close()
            raise LegFailed(f"{name} outlasted its limit of {timeout_s} s; log {log}")
        fh.close()
        wall = time.perf_counter() - t0
        text = log.read_text()
        if rc != 0:
            sys.stderr.write(text[-6000:])
            raise LegFailed(f"{name} failed (rc={rc}); log {log}")
        reports = [json.loads(line[len("PROD_LEG "):]) for line in text.splitlines()
                   if line.startswith("PROD_LEG ")]
        if len(reports) != 1:
            raise LegFailed(f"{name} printed {len(reports)} PROD_LEG lines; log {log}")
        print(f"[prod_drive] {name} OK in {wall:.1f} s", flush=True)
        return wall, text, reports[0]

    def run(self, name, driver, argv, timeout_s, expect=(), fwd=False, bwd=False) -> tuple:
        t0 = time.perf_counter()
        proc, fh, log = self.spawn(name, driver, argv)
        wall, text, report = self.finish(name, proc, fh, log, t0, timeout_s)
        self.hold(name, report, wall, fwd, bwd)
        missing = [str(p) for p in expect if not Path(p).exists()]
        if missing:
            raise LegFailed(f"{name} succeeded but left {missing} missing")
        return wall, text, report

    def hold(self, name, report, wall, fwd, bwd) -> None:
        """Record a child's report in the summary and hold it to its kernels
        (on the card) and to importing nothing of JAX. ``wall_s`` is the
        child's, process start included; ``main_s`` its driver's ``main``."""
        legs = self.summary.setdefault("legs", {})
        legs[name] = {"call": self.args.call, "card": self.card, "wall_s": round(wall, 1),
                      "main_s": round(report["seconds"], 1), "launches": report["launches"],
                      "foreign_modules": report["foreign_modules"]}
        if report["foreign_modules"]:
            raise LegFailed(f"{name} imported {report['foreign_modules']}")
        if self.args.device != "cpu":
            n = report["launches"]
            if fwd and n["composite_fwd"] == 0:
                raise LegFailed(f"{name} never launched composite_fwd")
            if bwd and n["composite_bwd"] == 0:
                raise LegFailed(f"{name} never launched composite_bwd")

    # -- legs
    def leg_dataset(self):
        a = self.args
        if self.data.exists():       # a different configuration's, or a cut run's
            shutil.rmtree(self.data)
        shutil.rmtree(self.subj / "stage1", ignore_errors=True)
        wall, _, rep = self.run(
            "dataset", "dataset",
            ["--data", self.data, "--out", self.out, "--cams", a.cams, "--frames", a.frames,
             "--nx", a.nx, "--res", a.res, "--device", a.device], LEG_TIMEOUT["dataset"],
            expect=[self.data / SUBJECT / SEQUENCE / "cameras.json",
                    self.subj / "stage1" / "template_uv.obj"], fwd=True)
        self.marker().touch()
        self.summary["dataset_s"] = round(wall, 1)
        self.summary["dataset"] = rep["stats"]

    def s2_argv(self, *extra):
        return ["-s", SUBJECT, "-q", SEQUENCE, *map(str, extra), "--device", self.args.device]

    def leg_s2_template(self):
        a = self.args
        wall, _, rep = self.run(
            "s2_template", "s2_registration",
            self.s2_argv("-tf", 0, "--first_frame_iterations", a.tmpl_iters,
                         "--ff_collision_iteration", a.tmpl_coll),
            LEG_TIMEOUT["s2_template"],
            expect=[self.s2 / "Template" / f for f in
                    ("template.obj", "local_point_cloud.ply", "point_cloud.ply", "binding.pkl")],
            fwd=True, bwd=True)
        self.summary["s2_template_s"] = round(wall, 1)
        self.summary.setdefault("s2_modes", {}).update(rep["stats"]["modes"])

    def leg_s2_sequence(self):
        a = self.args
        seq = self.s2 / SEQUENCE
        expect = [seq / "meshes" / f"frame_{t:05d}.obj" for t in range(a.frames)]
        expect += [seq / "logs" / f"frame_{t:05d}.jsonl" for t in range(a.frames)]
        expect += [seq / "point_cloud" / f"frame_{t:05d}" / "point_cloud.ply"
                   for t in range(a.frames)]
        wall, text, rep = self.run(
            "s2_sequence", "s2_registration",
            self.s2_argv("-t", "Template", "--eval",
                         "--first_frame_iterations_cross", a.frame_iters * 2,
                         "--other_frame_iterations", a.frame_iters,
                         "--collision_iteration", a.frame_coll,
                         "--ff_collision_iteration", a.frame_coll),
            LEG_TIMEOUT["s2_sequence"], expect=expect, fwd=True, bwd=True)
        self.summary["s2_sequence_s"] = round(wall, 1)
        self.summary["s2_early_stops"] = text.count("plateau at iter")
        self.summary.setdefault("s2_modes", {}).update(rep["stats"]["modes"])
        self.summary["s2_frame_iterations"] = {f"frame_{f['frame']:05d}": f["iterations"]
                                               for f in rep["stats"]["frames"]}

    def s3_argv(self, *extra):
        a = self.args
        return ["-s", SUBJECT, "--texture_size", a.texture, "--sh_degree", SH_DEGREE,
                "--ckpt_backend", "orbax", "--save_iterations", a.save_iterations,
                "--eval_items", EVAL_ITEMS, *extra, "--device", a.device]

    def leg_s3(self):
        """The first child is killed once its first checkpoint is committed
        with epochs left; the second resumes from it to the end."""
        from gaussian_garments_tpu_torch.training.checkpoints import has_s3_ckpt

        timeout_s = LEG_TIMEOUT["s3"]
        if self.s3_epoch() is None:
            t0 = time.perf_counter()
            proc, fh, log = self.spawn("s3_first", "s3_appearance", self.s3_argv())
            epoch = None
            while proc.poll() is None and time.perf_counter() - t0 < timeout_s:
                epoch = self.s3_epoch()
                if epoch is not None:
                    break
                time.sleep(0.02)
            alive = proc.poll() is None
            self.kill(proc)
            fh.close()
            first_s = time.perf_counter() - t0
            if epoch is None:
                sys.stderr.write(log.read_text()[-6000:])
                raise LegFailed("s3's first child ended or outlasted its limit before its "
                                f"first committed checkpoint; log {log}")
            if not alive or epoch >= 5:
                raise LegFailed(f"s3's first child was not killed mid-run (alive {alive}, "
                                f"epoch {epoch})")
            # the kill may cut a later save: what the resume sees is what
            # has_s3_ckpt recovers
            if not has_s3_ckpt(self.s3):
                raise LegFailed("no committed s3 checkpoint after the kill")
            kill_epoch = self.s3_epoch()
            print(f"[prod_drive] s3 killed at the first committed checkpoint (Epoch {epoch}) "
                  f"after {first_s:.1f} s", flush=True)
            self.summary.update(s3_interrupted=True, s3_first_leg_s=round(first_s, 1),
                                s3_kill_epoch=kill_epoch)
            self.summary.setdefault("legs", {})["s3_first"] = {
                "call": self.args.call, "card": self.card, "wall_s": round(first_s, 1),
                "killed_at_epoch": kill_epoch}
        else:
            self.summary.setdefault("s3_interrupted", False)
        wall, text, rep = self.run("s3_resume", "s3_appearance", self.s3_argv(), timeout_s,
                                   expect=[self.s3 / "ckpt" / f for f in
                                           ("net.pkl", "optm.pkl", "info.txt")]
                                   + [self.s3 / "logs" / "train.jsonl"], fwd=True, bwd=True)
        resumed = next((line for line in text.splitlines() if "Resumed from epoch" in line),
                       None)
        final = (self.s3 / "ckpt" / "info.txt").read_text().strip()
        if final != "Epoch 5":
            raise LegFailed(f"s3 ended at {final!r}, not 'Epoch 5'")
        if self.summary["s3_interrupted"]:
            k = int(resumed.split()[-1]) if resumed else None
            if k is None or not 1 <= k <= 4:
                raise LegFailed(f"s3's resume printed {resumed!r}, not an epoch in 1-4")
        stats = rep["stats"]
        self.summary.update(
            s3_resume_s=round(wall, 1), s3_resumed_from=resumed, s3_final_info=final,
            s3_eval=tail_jsonl(self.s3 / "logs" / "train.jsonl",
                               ("eval_psnr", "eval_ssim", "epoch")),
            s3_steps={k: {"n": m["n"], "s_per_step": m["seconds"] / max(m["n"], 1)}
                      for k, m in stats["steps"].items()},
            s3_items=stats["n_items"], s3_texels=stats["n_texels"])

    def leg_eval(self, tag):
        extra = ["--eval_only"] + (["--unet_bf16"] if tag == "bf16" else [])
        _, text, _ = self.run(f"eval_{tag}", "s3_appearance", self.s3_argv(*extra),
                              LEG_TIMEOUT[f"eval_{tag}"], fwd=True)
        lines = [line for line in text.splitlines() if line.startswith("EVAL_ONLY ")]
        if len(lines) != 1:
            raise LegFailed(f"eval_{tag} printed {len(lines)} EVAL_ONLY lines")
        self.summary.setdefault("unet_bf16_delta", {})[tag] = \
            json.loads(lines[0][len("EVAL_ONLY "):])

    def leg_inference(self):
        from gaussian_garments_tpu_torch.utils.io import read_obj

        a = self.args
        meshes = sorted((self.s2 / SEQUENCE / "meshes").glob("*.obj"))
        vs = [read_obj(m)["vertices"] for m in meshes]
        faces = read_obj(meshes[0])["faces"]
        body = vs[0].copy()
        body[:, 2] -= 2.0
        traj = {"pred": np.stack(vs).astype(np.float32), "cloth_faces": faces,
                "obstacle": np.stack([body] * len(vs)).astype(np.float32),
                "obstacle_faces": faces, "garment_names": [SUBJECT]}
        traj_path = self.root / "traj.pkl"
        with open(traj_path, "wb") as fh:
            pickle.dump(traj, fh)
        out_dir = self.root / "render_out"
        shutil.rmtree(out_dir, ignore_errors=True)
        wall, _, rep = self.run(
            "inference", "inference",
            ["--traj_path", traj_path, "--output_path", out_dir, "--sh_degree", SH_DEGREE,
             "--texture_size", a.texture, "--width", WIDTH, "--height", HEIGHT,
             "--device", a.device], LEG_TIMEOUT["inference"],
            expect=[out_dir / "renders" / f"{i:05d}.png" for i in range(len(vs))], fwd=True)
        n = len(list((out_dir / "renders").glob("*.png")))
        self.summary.update(inference_s=round(wall, 1), inference_frames=n,
                            inference_ms_per_frame=round(wall * 1000.0 / max(n, 1), 1),
                            inference_split=rep["stats"]["mean"])

    # -- the drive
    def carry_out(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with tarfile.open(path, "w:gz") as tar:
            for p in (self.s2, self.summary_path, self.logs):
                if p.exists():
                    tar.add(p, arcname=str(p.relative_to(self.root)))
        print(f"[prod_drive] carried out {path} ({path.stat().st_size} bytes)", flush=True)

    def main(self) -> dict:
        a = self.args
        if a.fresh and self.root.exists():
            shutil.rmtree(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        t_call = time.perf_counter()
        present = [leg for leg in LEGS if not leg.startswith("eval_") and self.done(leg)]
        if a.carry_in:
            with tarfile.open(a.carry_in) as tar:
                tar.extractall(self.root, filter="data")
            print(f"[prod_drive] carried in {a.carry_in}", flush=True)
        if self.summary_path.exists():
            self.summary = json.loads(self.summary_path.read_text())
            held = {k: v for k, v in self.summary.get("config", {}).items() if k != "fresh"}
            if held != self.config():
                raise LegFailed(f"{self.summary_path} holds another configuration: "
                                f"{self.summary.get('config')}; pass --fresh")
        else:
            self.summary = {"config": {**self.config(), "fresh": a.fresh}}
        calls = self.summary.setdefault("calls", {})
        calls[a.call] = {"card": self.card, "root_at_start": present,
                         "carried_in": bool(a.carry_in)}
        first, last = LEGS.index(a.from_leg), LEGS.index(a.until)
        for i, leg in enumerate(LEGS):
            if i > last:
                break
            if self.done(leg):
                print(f"[prod_drive] {leg}: artifacts present, skipped", flush=True)
                continue
            if i < first and leg != "dataset":
                raise LegFailed(f"--from {a.from_leg}: leg {leg} has not run; carry its "
                                "output in or start earlier")
            if leg.startswith("eval_"):
                self.leg_eval(leg[5:])
            else:
                getattr(self, f"leg_{leg}")()
            calls[a.call].setdefault("legs", []).append(leg)
            self.save()
        if self.done("s2_sequence") and "s2_frame_quality" not in self.summary:
            self.summary["s2_frame_quality"] = harvest_s2_quality(self.s2 / SEQUENCE / "logs")
        calls[a.call]["wall_s"] = round(time.perf_counter() - t_call, 1)
        self.summary["total_wall_s"] = round(sum(c.get("wall_s", 0.0) for c in calls.values()),
                                             1)
        self.summary["foreign_modules"] = foreign_modules()
        if self.summary["foreign_modules"]:
            raise LegFailed(f"the drive imported {self.summary['foreign_modules']}")
        self.save()
        if a.carry_out:
            self.carry_out(Path(a.carry_out).resolve())
        return self.summary


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = ArgumentParser(description="the whole pipeline at production scale, on the card")
    ap.add_argument("--root", default=str(REPO / "prod_drive_out"),
                    help="where the data, the output and the summary go")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--cams", type=int, default=12)
    ap.add_argument("--res", type=int, default=1024,
                    help="camera resolution (square; production render scale)")
    ap.add_argument("--nx", type=int, default=48,
                    help="cloth grid (48 -> 4.6K template verts)")
    ap.add_argument("--tmpl_iters", type=int, default=3000)
    ap.add_argument("--tmpl_coll", type=int, default=600)
    ap.add_argument("--frame_iters", type=int, default=1200)
    ap.add_argument("--frame_coll", type=int, default=240)
    ap.add_argument("--texture", type=int, default=512)
    ap.add_argument("--save_iterations", type=int, default=40)
    ap.add_argument("--fresh", action="store_true", help="wipe the root and start over")
    ap.add_argument("--from", dest="from_leg", choices=LEGS, default=LEGS[0],
                    help="first leg to run; earlier legs must be done (the dataset is "
                         "rebuilt when missing)")
    ap.add_argument("--until", choices=LEGS, default=LEGS[-1], help="last leg to run")
    ap.add_argument("--call", default="1", help="this call's name in the summary")
    ap.add_argument("--carry_in", default="", help="tarball of an earlier call to unpack")
    ap.add_argument("--carry_out", default="", help="tarball to write stage 2's output, the "
                                                    "summary and the logs to")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' raises when no GPU is present; 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    args.device = str(resolve_device(args.device).type)
    summary = Drive(args).main()
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--leg":
        rest = sys.argv[3:]
        sys.exit(run_child(sys.argv[2], rest[1:] if rest[:1] == ["--"] else rest))
    main()
