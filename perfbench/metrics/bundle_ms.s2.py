"""Host self time (ms) a traced s2 iteration in the program's ``bundle`` span
(``training/s2.splat_bundle``)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "bundle")
