"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

    python -m portbench.calibrate --workload <cell> --seeds <n,...> [--control-seeds <n,...>]

For each seed: the program's numbers (a train cell's first steps through
the window's own call; a forward cell's calls up to the last one its check
draws, at the cell's own load), each against the float32 reference.  For
each control seed also: the control, the reference computed with every
product's operands in fp8 (the precision below the configuration's bf16),
put in the program's place; and, for a train cell, the fault of half of
each batch left out (the mean over the rest): the reference put in the
program's place, fed each batch's first half.  A step that returns its state unchanged reads 1
on ``grad_gap`` and ``change_gap`` by their definition and needs no run.
Prints one JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run, spec


def readings(cell: spec.Cell, seed: int, device, control: bool) -> dict:
    t0 = time.perf_counter()
    entry, pool, _ = run.start(cell, seed, device)
    if cell.traffic["entry"] == "forward":
        for i in range(max(entry.checked) + 1):
            entry.call(i)
    outputs = [entry.free()]
    del entry
    torch.cuda.empty_cache()
    names = ["program"]
    if control:
        calls = sorted(outputs[0])
        outputs.append(run.reference_outputs(cell, seed, pool, device, calls, precision="fp8"))
        names.append("control_fp8")
        if cell.traffic["entry"] == "train":
            half = pool[:, : cell.traffic["batch"] // 2]
            outputs.append(run.reference_outputs(cell, seed, half, device))
            names.append("fault_half_batch")
    numbers = run.compare(cell, seed, pool, device, outputs)
    return {"seed": seed, "seconds": time.perf_counter() - t0, **dict(zip(names, numbers))}


def main(argv: list | None = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("portbench.calibrate: needs a CUDA card")
    torch.set_num_threads(1)
    cell = spec.find_cell(args.workload)
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(controls - set(seeds)):
        print(json.dumps({"workload": cell.name, **readings(cell, seed, device, seed in controls)}),
              flush=True)


if __name__ == "__main__":
    main()
