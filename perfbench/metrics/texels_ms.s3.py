"""Host self time (ms) a traced s3 step in the program's ``texels`` spans
(``training/s3._s3_project`` less the net)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "texels")
