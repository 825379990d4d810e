"""Host time of `phase_ab` with its loss reads, median per step of the traced stretch, ms."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "phase_ab")
