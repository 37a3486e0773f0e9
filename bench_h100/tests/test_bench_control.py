"""The check that decides ``correct`` has to fail what is wrong.

- On the CPU: whole runs of the harness (set-up, window, check against the
  reference) at a small size, with the program's timed path broken
  underneath, each see ``correct`` come out false: a step that returns its
  state unchanged, half of the batch left out (the rest repeated), and an
  answer altered where it is produced.  The cells run on one chip, so there
  is no exchange between chips to leave out.
- On the card (marker ``cuda``): the controls at the batch cells' own
  size read incorrect: the program computing in TF32 (``control.tf32_on``)
  in the kernel cell, and detecting on bfloat16 images
  (``control.bf16_images``) in the default cell.
"""

import contextlib

import numpy as np
import pytest
import torch

from bench_h100.common import harness
from bench_h100.common.program import port

SMALL = {
    "batch": {"batch": 2, "batches": 2, "check_frames": 4, "warm_calls": 1, "trace_calls": 2},
    "stream": {"pool": 3, "check_frames": 14, "warm_chunks": 1, "chunk": 2, "trace_calls": 1},
    "experiment": {"frames": 6, "sequences": 1, "warm_calls": 1, "trace_calls": 1},
}


def small_cell(name: str) -> harness.Cell:
    cell = harness.Cell(harness.load_benchmark(), name)
    cell.traffic.update(SMALL[cell.traffic["entry"]])
    cell.config["sequence_frames"] = 6
    return cell


def run_small(name: str, seconds: float = 0.5) -> dict:
    torch.set_num_threads(4)
    return harness.run_cell(small_cell(name), seed=2 ** 34 + 3, seconds=seconds, trace=False, device="cpu")


@contextlib.contextmanager
def patched(module, attr, make):
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


def _tree(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree(fn, x) for x in tree])
    return fn(tree)


def stale(orig):
    """compiled_batch whose step returns its first answer for every call."""
    def make(*args, **kw):
        step, first = orig(*args, **kw), []

        def run(a, b):
            if not first:
                first.append(step(a, b))
            return first[0]
        return run
    return make


def half_batch(orig):
    """compiled_batch whose step computes the first half of the frames and
    repeats it for the rest."""
    def make(*args, **kw):
        step = orig(*args, **kw)

        def run(a, b):
            h = a.shape[0] // 2
            out = step(a[:h], b[:h])
            return _tree(lambda x: torch.cat([x, x[: a.shape[0] - h]]), out)
        return run
    return make


def altered(orig):
    """compiled_batch whose step moves one grid point of frame 0 by 0.5 px."""
    def make(*args, **kw):
        step = orig(*args, **kw)

        def run(a, b):
            out = step(a, b)
            xy = out.detect1.grid.xy.clone()
            xy[0, int(torch.nonzero(out.detect1.grid.valid[0])[0])] += 0.5
            grid = out.detect1.grid._replace(xy=xy)
            return out._replace(detect1=out.detect1._replace(grid=grid))
        return run
    return make


@pytest.mark.parametrize("cell", ["cyl480-kernels.batch16", "cyl480-default.batch16"])
def test_sound_small_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["compared"]
    assert all(out["compared"][k]["value"] == 0 for k in ("ids", "flags", "points"))
    assert out["compared"]["tcyl"]["value"] > 0  # the fit is the reference's own, in float64


@pytest.mark.parametrize("fault", [stale, half_batch, altered], ids=["unchanged", "half", "altered"])
def test_broken_batch_step_reads_incorrect(fault):
    with patched(port().pipeline, "compiled_batch", fault):
        out = run_small("cyl480-kernels.batch16", seconds=1.5)
    assert not out["correct"]
    assert out["failed"] > 0


def test_stale_stream_chunk_reads_incorrect():
    def stale_chunk(orig):
        def make(*args, **kw):
            step, first = orig(*args, **kw), []

            def run(a, b):
                if not first:
                    first.append(step(a, b))
                return first[0]
            return run
        return make

    with patched(port().pipeline, "_stream_step", stale_chunk):
        out = run_small("cyl480-kernels.stream64")
    assert not out["correct"]


def test_altered_registration_reads_incorrect():
    def moved(orig):
        def run(*args, **kw):
            reg = orig(*args, **kw)
            t = reg.t_cam_agv.clone()
            t[0, 3] += 1.0
            return reg._replace(t_cam_agv=t)
        return run

    with patched(port().pipeline, "register_sequence", moved):
        out = run_small("cyl480-kernels.experiment100")
    assert not out["correct"]
    assert out["compared"]["reg_mm"]["value"] >= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [("cyl480-kernels.batch16", "tf32"), ("cyl480-default.batch16", "bf16")])
def test_control_reads_incorrect_on_the_card(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the program on the card")
    from bench_h100.control import CONTROLS

    # The switch is thrown before the process captures this cell's step: a
    # captured CUDA graph replays what it captured.
    undo = CONTROLS[control]()
    try:
        out = harness.run_cell(harness.Cell(harness.load_benchmark(), cell), seed=2 ** 33 + 11, seconds=3.0,
                               trace=False)
    finally:
        undo()
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["compared"].values())
