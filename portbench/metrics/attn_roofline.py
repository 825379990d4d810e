"""The attention kernels of the traced steps (`F.scaled_dot_product_attention`'s, forward and backward, whichever backend runs them: names holding `sdpa`, `flash` or `fmha`, and cuDNN's backward helpers `compute_dot_do_o` and `convert_dq_to_16bits`): the least time of SVTR's attention (`counts_svtr.attention_bound_s`, the windowed work only) over their device time, %."""

from portbench import readers

KERNELS = ("sdpa", "flash", "fmha", "compute_dot_do_o", "convert_dq_to_16bits")


def read(run):
    return readers.roofline(run, KERNELS, "attn_bound_s")
