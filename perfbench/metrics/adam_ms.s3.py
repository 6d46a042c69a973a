"""Host self time (ms) a traced s3 step in the program's ``adam`` span (Adam and
the statistics beside it)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "adam")
