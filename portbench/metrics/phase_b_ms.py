"""Host time of the area `phase_b` with the loss and CER reads, median per step, ms."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "phase_b")
