"""Host time of `make_steps().phase_a` on the word crops with its loss read, median per step, ms."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "phase_a")
