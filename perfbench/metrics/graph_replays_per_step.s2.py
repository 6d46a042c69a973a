"""CUDA graph replays a traced s2 iteration: the program's ``s2_graph.replay``
counter, 1.0 where every iteration replays its captured step. A program that
never counted a replay (one without the graph, or a step that stays eager)
gives nothing."""
from perfbench.harness import spans

NAME = "s2_graph.replay"


def read(run):
    w = spans.window(run)
    if w is None or NAME not in w.L.counters():
        return None
    return spans.count_per_step(run, NAME)
