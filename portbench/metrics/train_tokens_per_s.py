"""Target tokens trained over the whole window's time, in tokens/s."""

from portbench import readers


def read(run):
    return readers.tokens_per_s(run, "train")
