"""The readings that a cell's limits are set from, in one process.

    python -m vorbench.readings --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

For each of ``--seeds``, one run of the cell as ``vorbench.run`` makes it
(warm-up, a window of ``--seconds``, the check), its compared numbers on
one JSON line; for each of ``--control-seeds``, the same comparison of a
job that the control answered: the reference with its IMDCT in TF32 put in
the program's place, its compared numbers and ``correct``.  Needs the
card, as a run does.
"""

import argparse
import json
import sys
import time

from vorbench import cells, check, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    bench = cells.load_benchmark()
    import torch

    if not torch.cuda.is_available():
        print("vorbench.readings: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, compared, info = run.run_cell(bench, args.workload, seed,
                                         args.seconds, False, "cuda")
        print(json.dumps({"seed": seed, **compared, "jobs": info["jobs"],
                          "samples": info["samples"],
                          "clipped_samples": info["clipped_samples"],
                          "warmup": info["warmup"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    cell = run.Cell(bench, args.workload)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        blobs, sample = cell.jobs(seed)
        keeper = check.control_keeper(blobs, sample, cell.channels)
        compared, _ = check.compare(blobs, keeper)
        print(json.dumps({
            "control_seed": seed, **compared,
            "correct": check.verdict(compared, cell.config["check"]),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
