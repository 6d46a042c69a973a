"""Host self time (ms) a traced s3 step in the program's ``bin`` spans
(``ops/tiles.bin_pairs``), their ``sync`` children excluded."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "bin")
