"""The stream loop: ``estimate_poses_stream`` calls of ``sequence_frames``
uint8 frames (the configuration's sequence), back to back, each the next
stretch of a pool of ``pool`` scenes of ``example_pair`` (the
configuration's cylinder) tiled with ``TiledFrames``' per-frame grey
offset."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_h100.common import compare
from bench_h100.common.drivers import ORDER, SAMPLE, Driver, distinct, rng, take
from bench_h100.common.program import rig, to_host
from bench_h100.inputs import scenes


class _Span:
    """Frames [start, start + n) of an endless ``TiledFrames`` sequence."""

    def __init__(self, tiled, start: int, n: int):
        self.tiled, self.start, self.n = tiled, start, n

    @property
    def shape(self):
        return (self.n,) + self.tiled.shape[1:]

    def __getitem__(self, sl):
        a, b, _ = sl.indices(self.n)
        return self.tiled[slice(self.start + a, self.start + b)]


class Stream(Driver):
    entry = "stream"
    OFFSETS = scenes.TiledFrames.N_OFFSETS

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        t = traffic
        self.pool_n = t["pool"]
        pans = rng(seed, ORDER).permutation(np.arange(self.pool_n) % t["pans"]).astype(float)
        self.stereo, (i1, i2) = scenes.example_pair(self.h, self.w, n_frames=self.pool_n, seed=seed,
                                                    pans=list(pans), radius=cfg["fit"]["cyl_radius"])
        self.pools = (np.clip(i1, 0, 255).astype(np.uint8), np.clip(i2, 0, 255).astype(np.uint8))
        endless = 1 << 40
        self.tiled = tuple(scenes.TiledFrames(p, endless) for p in self.pools)
        self.n = cfg["sequence_frames"]
        codes = self.pool_n * self.OFFSETS
        self.sample = sorted(rng(seed, SAMPLE).choice(codes, t["check_frames"], replace=False).tolist())
        self.rig = rig(self.p, self.stereo, device)
        self.frames_per_call = self.n

    def window_values(self, times, wall):
        """Frames returned by the completed calls over their wall time."""
        return {"stream_frames_per_s": self.n * len(times) / wall}

    def _stream(self, start: int, n: int):
        t = self.traffic
        return self.p.pipeline.estimate_poses_stream(
            _Span(self.tiled[0], start, n), _Span(self.tiled[1], start, n), self.rig, self.detect_cfg,
            self.fit_cfg, chunk=t["chunk"], compact=t["compact"], overlap=t["overlap"], reg_cfg=self.reg_cfg)

    def warm(self):
        # The chunk step's key: its eager first chunk, then its capture.
        self._stream(0, self.traffic["warm_chunks"] * self.traffic["chunk"])

    def call(self, i: int) -> dict:
        return to_host(self._stream(i * self.n, self.n))

    def keep(self, i: int, ans: dict) -> None:
        idx = i * self.n + np.arange(self.n)
        code = (idx % self.pool_n) * self.OFFSETS + idx % self.OFFSETS
        for j in np.flatnonzero(np.isin(code, self.sample)):
            self.kept.append((int(code[j]), take(ans, j)))

    def readings(self) -> List[Dict[str, float]]:
        from bench_h100.reference import pipeline as ref

        pool, off = np.divmod(np.asarray(self.sample), self.OFFSETS)
        frames = [np.clip(p[pool].astype(np.int16) + off[:, None, None].astype(np.int16), 0, 255).astype(np.uint8)
                  for p in self.pools]
        c = self.cfg
        want = ref.poses(frames[0], frames[1], self.stereo, c["detect"], c["fit"], c["registration"])
        pos = {code: j for j, code in enumerate(self.sample)}
        return [compare.summary(ans, ref.summary(want[pos[code]])) for code, answers in distinct(self.kept).items()
                for ans in answers]


DRIVER = Stream
