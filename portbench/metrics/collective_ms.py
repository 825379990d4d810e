"""Stream time of the steps' collectives (`collective` spans: the summed gradients, the global counts and batch statistics, the gathered table rows) in rank 0's traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(run, ("collective",))
