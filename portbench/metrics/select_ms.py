"""Host time of `select_batch` (rangeCER) and the mask's read to the host, median per step, ms."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "select")
