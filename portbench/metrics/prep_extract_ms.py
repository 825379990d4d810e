"""Host time of `prep_extract` (UNet eval forward and strip gather), median per step of the traced stretch, ms."""

from portbench import readers


def read(run):
    return readers.span_ms(run, "prep_extract")
