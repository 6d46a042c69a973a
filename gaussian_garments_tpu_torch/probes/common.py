"""What the probes share: the entry record, timing, checking and bounds.

An ``Entry`` is one probe kernel at one shape: how to launch it, its plain
version and the one PyTorch call that computes the same function (if there
is one), how to hold the kernel's output against the plain one, the
bytes and operations its bound counts from this run's inputs, and, where
the kernel is shorter than a launch, an empty kernel at its grid: the
launch floor, timed the same way and printed beside the bound.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from gaussian_garments_tpu_torch.ops.cuda import KERNELS

# NVIDIA H100 SXM: HBM3 at 3.35 TB/s (data sheet); special-function units at
# 16 results per clock per SM (CUDA C++ programming guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.98 GHz boost.
HBM_BYTES_S = 3.35e12
SFU_OPS_S = 16 * 132 * 1.98e9
SLEEP_CYCLES = 4_000_000  # ~2 ms at the 1.98 GHz boost clock


@dataclasses.dataclass
class Entry:
    name: str                     # the kernel's name in ``ops.cuda.KERNELS``
    row: str                      # the TPU script's row it answers
    replaces: str                 # file:line of the TPU kernel at this row
    wrapper: Callable             # the kernel's wrapper; counts ``.launches``
    run: Callable[[], object]     # one launch of the kernel
    plain: Callable[[], object]   # the plain version on the same inputs
    compare: Callable[[object, object], Tuple[float, bool]]  # -> (max_abs_err, ok)
    tolerance: str
    nbytes: int                   # bytes the function must move
    evals: int = 0                # special-function evaluations it must do
    walked_evals: int = 0         # those its walk makes, where they differ
    library: Optional[Callable[[], object]] = None
    floor: Optional[Callable[[], object]] = None  # one launch of an empty kernel at its grid
    shape: str = ""

    @property
    def source(self) -> str:
        return f"gaussian_garments_tpu_torch/csrc/{KERNELS[self.name][0]}.cu"

    def bound(self, evals: Optional[int] = None) -> Tuple[float, str]:
        """(least ms the card could take, "bytes" or "operations"), for
        ``evals`` special-function evaluations (default: ``self.evals``)."""
        t_bytes = self.nbytes / HBM_BYTES_S
        t_ops = (self.evals if evals is None else evals) / SFU_OPS_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean ms of ``fn`` over ``reps`` launches by CUDA events, after one
    warm-up call. The card is kept busy (``torch.cuda._sleep``, ~2 ms) while
    the host enqueues the timed launches, so that a kernel shorter than its
    wrapper's host time (~20 µs) runs back to back and is timed on the card,
    not at the host's pace."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(entry: Entry) -> Tuple[float, bool]:
    """The kernel against its plain version on the entry's inputs."""
    got = entry.run()
    want = entry.plain()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return entry.compare(got, want)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def report(entries, device: torch.device, reps: int, extra=None) -> list:
    """The probe CLI's body: check every entry and, on the card, time the
    kernel, its plain version and the library call. Prints one line per
    entry and returns the rows."""
    rows = []
    on_card = device.type == "cuda"
    for e in entries:
        err, ok = check(e)
        row = {"name": e.name, "row": e.row, "replaces": e.replaces, "source": e.source,
               "tolerance": e.tolerance, "ok": ok, "max_abs_err": err}
        if on_card:
            row["ms"] = cuda_ms(e.run, reps)
            row["plain_ms"] = cuda_ms(e.plain, 1)
            row["library_ms"] = cuda_ms(e.library, reps) if e.library else None
            row["floor_ms"] = cuda_ms(e.floor, reps) if e.floor else None
        row["bound_ms"], row["bound_by"] = e.bound()
        walked = ""
        if e.walked_evals:
            row["walked_bound_ms"] = e.bound(e.walked_evals)[0]
            walked = (f" ({e.evals} evaluations; walked {e.walked_evals}: "
                      f"{row['walked_bound_ms']:.4f} ms)")
        rows.append(row)
        times = (f"{row['ms']:9.4f} ms (CUDA events, mean of {reps})" if on_card
                 else "ms not measured (cpu)")
        lib = f", library {row['library_ms']:.4f} ms" if on_card and e.library else ""
        floor = f", floor {row['floor_ms']:.4f} ms" if on_card and e.floor else ""
        print(f"{e.row:>6} {e.name:<20} ok={ok} max|err|={err:.3g}  {times}, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}{floor}{walked}{lib}  "
              f"[{e.shape}]", flush=True)
        if extra:
            extra(e, row)
    return rows
