"""The batch loop: ``compiled_batch`` calls of ``batch`` stereo pairs,
cycling through ``batches`` distinct batches cut from a pool of
``batch * batches`` scenes of ``example_pair`` (the configuration's
cylinder at pans 0 .. ``pans``-1, spread evenly), float32 host frames
copied to the card in each call and every output leaf read back."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_h100.common import compare, stats
from bench_h100.common.drivers import ORDER, SAMPLE, Driver, distinct, rng, take
from bench_h100.common.program import rig, to_host
from bench_h100.inputs import scenes


class Batch(Driver):
    entry = "batch"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        t = traffic
        self.batch, n_batches = t["batch"], t["batches"]
        pool = self.batch * n_batches
        pans = rng(seed, ORDER).permutation(np.arange(pool) % t["pans"]).astype(float)
        self.stereo, (i1, i2) = scenes.example_pair(self.h, self.w, n_frames=pool, seed=seed, pans=list(pans),
                                                    radius=cfg["fit"]["cyl_radius"])
        self.frames = (i1, i2)
        self.batches = [(np.ascontiguousarray(i1[k * self.batch:(k + 1) * self.batch]),
                         np.ascontiguousarray(i2[k * self.batch:(k + 1) * self.batch])) for k in range(n_batches)]
        self.sample = sorted(rng(seed, SAMPLE).choice(pool, t["check_frames"], replace=False).tolist())
        self.rig = rig(self.p, self.stereo, device)
        self._steps: dict = {}
        self.frames_per_call = self.batch

    def window_values(self, times, wall):
        """Pairs posed over the window's wall time; the 95th percentile of
        every call's time."""
        return {"batch_frames_per_s": self.batch * len(times) / wall,
                "batch_p95_ms": 1e3 * stats.percentile(times, 95.0)}

    def step(self, probe=None):
        if probe not in self._steps:
            self._steps[probe] = self.p.pipeline.compiled_batch(self.rig, self.detect_cfg, self.fit_cfg, probe)
        return self._steps[probe]

    def step_ms(self, run, probe=None) -> float:
        """Device ms of one replay of the step (``probe="detect"``: of its
        detect step) on the first batch, by CUDA events (``run.cuda_ms``)."""
        def measure():
            da, db = self.upload(*self.batches[0])
            step = self.step(probe)
            return run.cuda_ms(lambda: step(da, db), self.traffic["event_reps"])
        return run.memo(("step_ms", probe), measure)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int) -> dict:
        a, b = self.batches[i % len(self.batches)]
        da, db = self.upload(a, b)
        return to_host(self.step()(da, db))

    def keep(self, i: int, ans: dict) -> None:
        k = i % len(self.batches)
        for f in self.sample:
            if f // self.batch == k:
                self.kept.append((f, take(ans, f - k * self.batch)))

    def readings(self) -> List[Dict[str, float]]:
        from bench_h100.reference import pipeline as ref

        i1, i2 = self.frames
        c = self.cfg
        want = ref.poses(i1[self.sample], i2[self.sample], self.stereo, c["detect"], c["fit"], c["registration"])
        pos = {f: j for j, f in enumerate(self.sample)}
        return [compare.frame(ans, want[pos[f]], c["registration"]) for f, answers in distinct(self.kept).items()
                for ans in answers]


DRIVER = Batch
