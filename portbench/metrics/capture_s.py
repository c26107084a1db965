"""``jit``'s warm-up calls and capture of the cell's one signature, on the
host's clock, the warm-ups' device work included (the program's counters
``jit.warmup_s`` and ``jit.capture_s``), in s: the part of set-up that
the program's own capture takes."""

from portbench import program


def read(run):
    return program.capture_s(run)
