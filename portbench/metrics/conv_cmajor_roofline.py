"""The channel-major conv kernel (`conv_cmajor_kernel`) of the traced requests: least time over device time, %."""

from portbench import readers


def read(run):
    return readers.roofline(run, ("conv_cmajor_kernel",), "conv_bound_s")
