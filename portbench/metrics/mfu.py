"""The cell's model FLOPs a step over the untraced part's host time, against 989 TFLOP/s, %."""

from portbench import readers


def read(run):
    return readers.mfu(run)
