"""Share of the traced stretch with no device operation running, %."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
