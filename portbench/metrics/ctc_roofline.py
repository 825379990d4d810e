"""The CTC kernels (`ctc_alpha_kernel`, `ctc_beta_grad_kernel`) of the traced steps: their least time over their device time, %."""

from portbench import readers


def read(run):
    return readers.roofline(run, ("ctc_alpha_kernel", "ctc_beta_grad_kernel"), "ctc_bound_s")
