"""Host self time (ms) a traced s2 iteration in the program's ``energies`` span
(``mesh_model.get_energy_loss``)."""
from perfbench.harness import spans


def read(run):
    return spans.ms_per_step(run, "energies")
