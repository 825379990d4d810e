"""Stream time of the UNet's batch norm + ReLU (`unet.norm` spans and their backwards, `unet.norm.backward`) in the traced stretch, over its training steps, ms."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_step(
        run, ("unet.norm", "unet.norm.backward"))
