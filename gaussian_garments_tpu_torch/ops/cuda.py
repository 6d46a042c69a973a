"""The port's hand-written CUDA kernels: source registry, nvcc build and
ctypes loader.

Every kernel source lives in ``csrc/`` and exposes a plain C interface, so
it builds with nvcc alone (no PyTorch headers) into a shared library under
the git-ignored ``build/``, keyed by a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, and is
loaded with ctypes. ``build_kernels()`` starts one nvcc per source, all at
once. Nothing is built when this module is imported: a library is built at
the first launch of one of its kernels, or by an explicit ``build_kernels()``.

``KERNELS`` names every kernel the port launches, the source it is built
from and the TPU kernel of the JAX package it replaces (file:line).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source -> {C entry point: argument codes}; "p" a pointer (or the stream),
# "i" an int, "l" a 64-bit int. Every entry point returns cudaGetLastError().
SOURCES = {
    "composite_fwd": {"gg_composite_fwd": "pppiiiipppppp"},
    "composite_bwd": {"gg_composite_bwd": "ppppppppiiiipp"},
    "probe_gather": {"gg_gather_flat_l2": "ppplp",
                     "gg_gather_flat_cluster": "pppliilip",
                     "gg_gather_axis0": "pppiip",
                     "gg_gather_axis1": "pppiiip"},
    "probe_composite": {"gg_probe_null": "pppiiiippppppp",
                        "gg_probe_alpha_only": "pppiiiipp",
                        "gg_grid_ladder": "ppppppppppplip"},
}

# kernel -> (source, the TPU kernel it replaces). The probes' rows of the
# JAX scripts' tables name their shapes in ``probes/``.
KERNELS = {
    "composite_fwd": ("composite_fwd", "gaussian_garments_tpu/ops/pallas_tiles.py:666"),
    "composite_bwd": ("composite_bwd", "gaussian_garments_tpu/ops/pallas_tiles.py:830"),
    "gather_flat_l2": ("probe_gather", "scripts/profile_pallas_gather.py:42"),
    "gather_flat_cluster": ("probe_gather", "scripts/profile_pallas_gather.py:42"),
    "gather_axis0": ("probe_gather", "scripts/profile_pallas_gather2.py:46"),
    "gather_axis1": ("probe_gather", "scripts/profile_pallas_gather2.py:72"),
    "probe_null": ("probe_composite", "scripts/profile_kernel_null.py:81"),
    "probe_alpha_only": ("probe_composite", "scripts/profile_kernel_null.py:93"),
    "grid_a": ("probe_composite", "scripts/profile_grid_overhead.py:72"),
    "grid_b": ("probe_composite", "scripts/profile_grid_overhead.py:101"),
    "grid_c": ("probe_composite", "scripts/profile_grid_overhead.py:124"),
    "grid_d": ("probe_composite", "scripts/profile_grid_overhead.py:147"),
    "grid_e": ("probe_composite", "scripts/profile_grid_overhead.py:178"),
}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
_libs = {}
_lib_lock = threading.Lock()


def source_path(source: str) -> Path:
    return CSRC / f"{source}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(f"nvcc not found: the kernels are built from {CSRC} with the CUDA "
                       "toolkit at first use")


def library_path(source: str) -> Path:
    """The library of ``source``, keyed by its source, the shared headers
    ``csrc/*.cuh`` and the flags."""
    digest = hashlib.sha256(source_path(source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgg_{source}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> dict:
    """Compile ``csrc/<source>.cu`` into ``build/`` unless a library of the
    same source and flags is there. Returns {path, seconds, ptxas}."""
    so = library_path(source)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "ptxas": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(source))],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path(source)}:\n{res.stderr}")
    os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "ptxas": res.stderr.strip()}


def build_kernels() -> dict:
    """Build every source, one nvcc per source, all started together.
    Returns {source: build(source)}; raises if any build fails."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def library(source: str):
    """The loaded library of ``source``, built first if needed, with the
    argument and result types of its entry points set."""
    with _lib_lock:
        if source not in _libs:
            lib = ctypes.CDLL(build(source)["path"])
            for fn, codes in SOURCES[source].items():
                getattr(lib, fn).argtypes = [_CTYPES[c] for c in codes]
                getattr(lib, fn).restype = ctypes.c_int
            lib.gg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gg_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return _libs[source]


def launch(source: str, fn: str, *args) -> None:
    """Call entry point ``fn`` of ``source``; raise if the launch failed."""
    lib = library(source)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: " + lib.gg_cuda_error_string(err).decode())


def stream(device) -> int:
    """The current stream of ``device`` as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(t, name: str, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape``, when given): what a kernel takes."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def route(dev, cuda_fn, plain_fn):
    """The kernel's wrapper for CUDA tensors, its plain version for CPU
    tensors; any other device raises. There is no fallback between them."""
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return plain_fn
    raise RuntimeError(f"no kernel for device {dev}")
