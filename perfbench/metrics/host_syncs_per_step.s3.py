"""Host syncs a traced s3 step: the program's ``host_syncs`` counter."""
from perfbench.harness import spans


def read(run):
    return spans.count_per_step(run, "host_syncs")
