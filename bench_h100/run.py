"""Runs one cell of the H100 benchmark of ``cylinder_pose_estimation_tpu_torch``
once and prints its result as the last line of standard output:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds`` of whole calls; ``--trace 1`` traces a few whole calls and
reads the cell's per-layer metrics.  Either way the answers of the window
are checked against the plain reference (``reference/``) afterwards, and
the numbers compared are printed beside their limits as the last lines of
standard error.  Needs as many CUDA devices as the cell names; with fewer,
or none, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)
    from bench_h100.common import harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    smi = harness.card_info(cell.chips)
    print(f"{args.workload} seed {args.seed}: {smi}", file=sys.stderr, flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
