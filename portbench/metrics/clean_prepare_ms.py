"""Host time a request of `clean_arrays_uint8`'s `fit`, `quantise` and `upload` spans (pad into the canvas, round to uint8, host to device), ms."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms_per_root(
        run, ("fit", "quantise", "upload"), "clean")
