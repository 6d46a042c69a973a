"""Run one cell of the benchmark of ``gaussian_garments_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and, with ``--trace 1``, ``breakdown``), then ``checks``, each
number compared with its limit; the same numbers are the last lines of
standard error. Exits non-zero, printing no result, without a CUDA device.
Build caches stay inside the checkout (``.bench_cache/``)."""
import os
import sys
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, root)
    from perfbench.harness.bench import main

    sys.exit(main(sys.argv[1:], t_process=T_PROCESS))
