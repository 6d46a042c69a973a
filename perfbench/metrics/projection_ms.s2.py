"""Host self time (ms) a traced s2 iteration in the program's ``project`` spans
(``renderer._project``)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "project")
