"""The share of the traced stretch of the forward entry in which no kernel
ran on the card, in %."""

from portbench import readers


def read(run):
    return readers.idle_share(run, "forward")
