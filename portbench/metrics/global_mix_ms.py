"""Stream time of SVTR's global blocks (`svtr.global` spans and their backwards, `svtr.global.backward`) in the traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(
        run, ("svtr.global", "svtr.global.backward"))
