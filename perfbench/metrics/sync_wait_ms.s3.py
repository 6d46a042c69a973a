"""Host self time (ms) a traced s3 step in the program's ``sync`` spans: the host
waiting on the device at each read of a device value or copy from the host."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "sync")
