"""Host self time (ms) a traced s3 step in the program's ``unet`` span (the
appearance net's ``functional_call``)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "unet")
