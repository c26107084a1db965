"""The MLP's kernels (csrc/mlp.cu) in the forward entry: the least time of
their calls over their device time, in %."""

from portbench import readers


def read(run):
    return readers.roofline(run, "mlp", "forward")
