"""The backward compositor's least time for the counted work
(``counters.composite.backward``) over its device time a step, s3 cells."""
from perfbench.harness.readers import roofline_pct

KERNEL = "composite_bwd_kernel"


def read(run):
    return roofline_pct(run, KERNEL, "composite_bwd")
