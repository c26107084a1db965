"""Start of the process to the first timed call, in s: imports, the
context, weights and tokens on the card, the kernels loaded (built on a
checkout's first run), the warm-up and capture of the cell's one signature
and, for a train cell, its first steps."""


def read(run):
    return run.setup_s
