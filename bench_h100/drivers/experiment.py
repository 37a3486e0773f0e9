"""The calibration loop: ``full_experiment`` calls on ``frames`` stereo
pairs of ``registration_sequence`` (pan +-``pan``, tilt +-``tilt`` rad),
cycling through ``sequences`` sequences of the seed (same angles, own
noise): frames and angles copied to the card in each call, the poses and
the registration read back."""

from __future__ import annotations

from typing import Dict, List

from bench_h100.common import compare
from bench_h100.common.drivers import NOISE, SAMPLE, Driver, distinct, rng, take
from bench_h100.common.program import rig, to_host
from bench_h100.inputs import scenes


class Experiment(Driver):
    entry = "experiment"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        t = traffic
        self.angles = scenes.registration_angles(t["frames"], t["pan"], t["tilt"])
        self.seqs = []
        for k in range(t["sequences"]):
            self.stereo, _, (i1, i2), _ = scenes.registration_sequence(
                t["frames"], self.h, self.w, seed=[seed, NOISE, k], angles=self.angles,
                radius=cfg["fit"]["cyl_radius"])
            self.seqs.append((i1, i2))
        self.sample = sorted(rng(seed, SAMPLE).choice(t["sequences"], t["check_sequences"], replace=False).tolist())
        self.rig = rig(self.p, self.stereo, device)
        self.frames_per_call = t["frames"]

    def window_values(self, times, wall):
        """Window wall time over the completed experiments."""
        return {"experiment_ms": 1e3 * wall / len(times)}

    def step(self):
        return self.p.pipeline.compiled_batch(self.rig, self.detect_cfg, self.fit_cfg)

    def inputs(self, k: int):
        return self.upload(*self.seqs[k], self.angles)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int) -> dict:
        da, db, ang = self.inputs(i % len(self.seqs))
        batch, reg = self.p.pipeline.full_experiment(da, db, ang, self.rig, self.detect_cfg, self.fit_cfg,
                                                     self.reg_cfg)
        return {"poses": to_host(batch), "reg": to_host(reg)}

    def keep(self, i: int, ans: dict) -> None:
        k = i % len(self.seqs)
        if k in self.sample:
            self.kept.append((k, ans))

    def readings(self) -> List[Dict[str, float]]:
        from bench_h100.reference import pipeline as ref

        c, out = self.cfg, []
        for k, answers in distinct(self.kept).items():
            i1, i2 = self.seqs[k]
            poses = ref.poses(i1, i2, self.stereo, c["detect"], c["fit"], c["registration"])
            reg = ref.registration(poses, self.angles, c["registration"])
            for ans in answers:
                frames = [compare.frame(take(ans["poses"], f), poses[f], c["registration"],
                                        self.traffic.get("compare_detection", "all")) for f in range(len(i1))]
                out.append(compare.merge(frames + [compare.registration(ans["reg"], reg)]))
        return out


DRIVER = Experiment
