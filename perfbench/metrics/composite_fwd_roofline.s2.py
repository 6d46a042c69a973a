"""The forward compositor's least time for the counted work
(``counters.composite.forward``) over its device time a step, s2 cells."""
from perfbench.harness.readers import roofline_pct

KERNEL = "composite_fwd_kernel"


def read(run):
    return roofline_pct(run, KERNEL, "composite_fwd")
