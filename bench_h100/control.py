"""Readings of the check that decides ``correct``, for the program and for
its control, over many seeds in one process: what each limit in
``limits/<cell>.json`` is set from.  The benchmark's own runs never run it.

    python3 bench_h100/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control tf32|bf16]

Without ``--control`` each seed is a sound run of the cell (the program as
the configuration states it: float32 with TF32 off).  One process runs one
kind: the program keeps each step's captured CUDA graph for the process,
so a switch thrown after a sound run had captured would replay the sound
graph.  The controls, which
the check must find incorrect, run the program one step below the
configuration's precision: ``tf32`` its matmuls and convolutions in TF32;
``bf16`` its detection images in bfloat16 (the program's own
``image_dtype="bfloat16"`` path of the XLA branch), the reference staying
at the configuration's precision.  Each seed runs the cell's set-up, a
window of ``--seconds`` of whole calls at the cell's own sizes and the
comparison with the plain reference, and prints one JSON line of its
readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def tf32_on():
    """Make the program compute in TF32: its own switch (``exact_float32``,
    called by every ``estimate_poses_batch``) turns TF32 on instead of off.
    Returns the undo."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import pipeline

    exact = pipeline.exact_float32

    def on() -> None:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    pipeline.exact_float32 = on
    on()

    def undo() -> None:
        pipeline.exact_float32 = exact
        exact()

    return undo


def bf16_images():
    """Make the program detect on bfloat16 images: its detection config,
    and only the program's, takes ``image_dtype="bfloat16"``.  Returns the
    undo."""
    import dataclasses

    from bench_h100.common import drivers

    configs = drivers.configs

    def lowered(p, cfg):
        detect, fit, reg = configs(p, cfg)
        return dataclasses.replace(detect, image_dtype="bfloat16"), fit, reg

    drivers.configs = lowered

    def undo() -> None:
        drivers.configs = configs

    return undo


CONTROLS = {"tf32": tf32_on, "bf16": bf16_images}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from bench_h100.common import harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    print(harness.card_info(cell.chips), file=sys.stderr, flush=True)
    if args.control:
        CONTROLS[args.control]()
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, trace=False)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": out["correct"], "failed": out["failed"], "metrics": out["metrics"],
                          "readings": {k: v["value"] for k, v in out["compared"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
