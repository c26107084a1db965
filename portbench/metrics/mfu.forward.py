"""The model's operations for the traced calls of the forward entry over their
time, as a share of the card's bf16 peak (989 TFLOP/s), in %."""

from portbench import readers


def read(run):
    return readers.mfu(run, "forward")
