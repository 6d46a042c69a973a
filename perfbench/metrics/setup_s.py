"""Set-up: from process start to the first timed step (loading, the
inputs, building the program, warming every shape it runs)."""


def read(run):
    return run.setup_s
