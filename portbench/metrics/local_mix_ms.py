"""Stream time of SVTR's local blocks (`svtr.local` spans and their backwards, `svtr.local.backward`) in the traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(
        run, ("svtr.local", "svtr.local.backward"))
