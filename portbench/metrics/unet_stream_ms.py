"""Stream time of the UNet's forwards and backwards (`unet.forward`, `unet.backward` spans) in the traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(
        run, ("unet.forward", "unet.backward"))
