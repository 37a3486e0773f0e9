#!/usr/bin/env python3
"""Time the PyTorch port's command-line drivers on one CUDA card, as a user
runs them: one fresh process per command.

    python3 tools/torch_cli_time.py [--root DIR ...] [--frames 4] [--turns 3]

Writes ``--frames`` stereo pairs of ``utils.synthetic.
write_registration_folder`` (480x640, with the rig's ``cameras.json``) to a
temporary directory, then runs ``python -m cylinder_pose_estimation_tpu_torch.cli
<command> --camera-json ... --input ... --device cuda`` for ``experiment
--no-clahe`` (chip_smoke phase 14's arguments) and ``detect-folder``, with
each ``--root`` first on the import path (default: this checkout), roots in
turns (the order reversed every other turn).  Prints each command's wall
seconds per root (the median over ``--turns``, every turn's beside it) with
the card's name and power limit, and ends with one JSON line of them.  Give
two roots (a parent's checkout and this one) to compare them on one card in
one run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import write_registration_folder

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    commands = {"experiment": ["experiment", "--no-clahe"], "detect-folder": ["detect-folder", "--output"]}
    walls = {r: {c: [] for c in commands} for r in roots}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        write_registration_folder(src, args.frames, 480, 640)
        cam = os.path.join(src, "cameras.json")
        for turn in range(args.turns):
            for root in (roots if turn % 2 == 0 else roots[::-1]):
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
                for name, argv in commands.items():
                    if name == "detect-folder":
                        argv = argv + [os.path.join(tmp, "out")]
                    cmd = [sys.executable, "-m", "cylinder_pose_estimation_tpu_torch.cli", argv[0],
                           "--camera-json", cam, "--input", src, *argv[1:], "--device", "cuda"]
                    t0 = time.perf_counter()
                    subprocess.run(cmd, cwd=tmp, env=env, check=True, capture_output=True)
                    walls[root][name].append(time.perf_counter() - t0)
    out = {"card": smi, "frames": args.frames, "turns": args.turns,
           "wall_s": {r: {c: {"median": statistics.median(t), "turns": t} for c, t in w.items()}
                      for r, w in walls.items()}}
    for r, w in out["wall_s"].items():
        for c, v in w.items():
            print(f"{r}: {c} ({args.frames} frames) {v['median']:.3f} s wall (median of "
                  f"{[round(x, 3) for x in v['turns']]}); {smi}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
