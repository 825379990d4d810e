"""Device operations of the traced stretch (kernels, copies and sets) over the program's training steps (its `phase_ab` / `phase_b` root spans), a step."""

from portbench import program_spans


def read(run):
    n = program_spans.steps(run)
    if not n or not run.kernels:
        return None
    return len(run.kernels) / n
