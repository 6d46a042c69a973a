"""Host self time (ms) a traced s3 step in the program's ``backward`` span
(``torch.autograd.grad``)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "backward")
