"""The strip gather kernels (`gather_fwd_kernel`, `gather_bwd_kernel`) of the traced steps: least time over device time, %."""

from portbench import readers


def read(run):
    return readers.roofline(run, ("gather_fwd_kernel", "gather_bwd_kernel"), "gather_bound_s")
