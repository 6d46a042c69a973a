"""CUDA graph replays a traced s3 step: the program's ``s3_graph.replay``
counter, 1.0 where every step replays its captured step. A program that
never counted a replay (one without the graph, or a step that stays eager)
gives nothing."""
from perfbench.harness import spans

NAME = "s3_graph.replay"


def read(run):
    w = spans.window(run)
    if w is None or NAME not in w.L.counters():
        return None
    return spans.count_per_step(run, NAME)
