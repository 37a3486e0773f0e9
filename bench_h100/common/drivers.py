"""What the loop drivers share, and how the harness finds one: a traffic
file names an ``entry`` of the program and its parameters, and the driver
of that entry is ``drivers/<entry>.py`` (its ``DRIVER`` class), loaded by
name, so that a new kind of loop is a new file.  A driver makes the cell's
inputs from the seed, warms up the shapes the cell uses, runs one call at a
time (closed loop: one caller, the next call once the last has returned),
keeps the answers the seed samples for the check, and compares them with
the plain reference once the window has closed.

Every driver keeps the same set of scenes for every seed (the poses are a
fixed multiset, the seed draws their order, the noise and the sample), so
that a seed changes the inputs and not the amount of work.
"""

from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from bench_h100.common import compare
from bench_h100.common.program import configs, port

BENCH = Path(__file__).resolve().parents[1]

# Streams of the seed: one per use, so that adding a use moves no other.
NOISE, ORDER, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def digest(tree) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.digest()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def take(tree, j):
    """Frame j of a tree whose leaves carry a leading frame axis (a copy)."""
    if isinstance(tree, dict):
        return {k: take(v, j) for k, v in tree.items()}
    return np.array(tree[j])


def distinct(answers: List[Tuple[object, dict]]) -> Dict[object, List[dict]]:
    """The distinct answers of each key, in order of first appearance."""
    out: Dict[object, Dict[bytes, dict]] = {}
    for key, ans in answers:
        out.setdefault(key, {}).setdefault(digest(ans), ans)
    return {k: list(v.values()) for k, v in out.items()}


class Driver:
    """Common state: the port, its configs and rig on ``device``, the
    answers kept for the check."""

    entry = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.p = port()
        self.detect_cfg, self.fit_cfg, self.reg_cfg = configs(self.p, cfg)
        self.h, self.w = cfg["height"], cfg["width"]
        self.kept: List[Tuple[object, dict]] = []

    def upload(self, *arrays):
        import torch

        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def window_values(self, times: List[float], wall: float) -> Dict[str, float]:
        """The entry's end-to-end metrics of a window of whole calls (each
        call's host seconds, the window's wall seconds)."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the harness's references to the program's device state."""
        self.rig = None
        self._steps = {}

    def judge(self, limits: Dict[str, dict]) -> Tuple[Dict[str, float], int, int]:
        """(readings over every compared answer, answers compared, answers
        with a number over its limit)."""
        per_answer = self.readings()
        failed = sum(1 for r in per_answer if compare.over(r, limits))
        return compare.merge(per_answer), len(per_answer), failed


def load(entry: str, root: Path = BENCH.parent):
    """The ``DRIVER`` class of ``drivers/<entry>.py``."""
    path = root / BENCH.name / "drivers" / f"{entry}.py"
    if not path.exists():
        raise KeyError(f"no driver {path.name} for the traffic entry {entry!r}")
    spec = importlib.util.spec_from_file_location(f"bench_h100_driver_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DRIVER


def make(cfg: dict, traffic: dict, seed: int, device: str, root: Path = BENCH.parent) -> Driver:
    return load(traffic["entry"], root)(cfg, traffic, seed, device)
