"""Stream time of the CRNN's forwards and backwards (`crnn.forward`, `crnn.backward` spans) in the traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(
        run, ("crnn.forward", "crnn.backward"))
