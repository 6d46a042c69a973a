"""Host self time (ms) a traced s2 iteration in the program's ``loss`` spans (L1,
SSIM and the hinges)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "loss")
