"""PyTorch port, on the CPU: a model of the bridge's split route
(``csrc/bridge.cu`` ``bridge_split``) kept in this file, held to
``bridge_morphology_plain``.

The model follows the kernel: a mask's rows are split over c CTAs of R
rows; each CTA holds its rows of four planes (M, E, X, Y) and reads a row it
does not own from the CTA that owns it.  The passes run in the kernel's
order with its plane reuse: the packing of M and E; one ray pass
(X = M & E & (forward count <= 1 | backward count <= 1), the counts summed
from the ray offsets' totals); the line steps X <-> Y (steps of offset
(0, 0) skipped); G1 -> E; grown -> the line's other plane; E1 -> the line's
last plane; R -> E.  The barriers are the kernel's, and the model checks
them: a CTA reads its own rows only after a CTA barrier since they were
written, another CTA's rows only after a cluster barrier, and writes a
plane only after a cluster barrier since another CTA last read its rows.
No JAX here: ``tests/test_torch_kernels.py`` holds the plain version to the
Pallas kernel."""

import math

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def ray_totals(ray, probe_len):
    """(2, probe_len, 2) int64: the offsets T whose shifted masks m(y + T)
    the doubling of ``bridge_morphology_plain`` sums, per ray direction.
    pows[p] sums O_p, O_1 = [d(1)], O_2p = O_p + (O_p + d(p)), so its entry
    i is d(1) plus d(q) for every bit q of i; the part of bit p is pows[p]
    shifted by d(the bits of probe_len above p).  ``ray``: (2, probe_len + 1,
    2), one mask's ``bridge_schedule`` ray.  As the kernel's warp 0, entry
    by entry."""
    out = torch.empty((2, probe_len, 2), dtype=torch.int64)
    for s in range(2):
        d = ray[s].to(torch.int64)
        for k in range(probe_len):
            rem, off = k, 0
            p = 1 << (probe_len.bit_length() - 1)
            while p:
                if probe_len & p:
                    if rem < p:
                        break
                    rem -= p
                    off += p
                p >>= 1
            t = d[1] + d[off]
            q = 1
            while q <= rem:
                if rem & q:
                    t = t + d[q]
                q <<= 1
            out[s, k] = t
    return out


class Cluster:
    """One mask's c CTAs: each holds rows [rank R, rank R + R) of four planes
    and tracks the writes and reads that the barriers must order."""

    PLANES = ("M", "E", "X", "Y")

    def __init__(self, h, w, rows):
        self.h, self.w, self.rows = h, w, rows
        self.c = -(-h // rows)
        self.buf = {p: [torch.zeros((rows, w), dtype=torch.bool) for _ in range(self.c)] for p in self.PLANES}
        self.local_dirty = [set() for _ in range(self.c)]  # planes written since the CTA's last barrier
        self.remote_dirty = set()                          # (plane, rank) written since the last cluster barrier
        self.remote_read = set()                           # (plane, owner) read by another CTA since then

    def own(self, rank):
        r0 = rank * self.rows
        return r0, min(self.rows, self.h - r0)

    def syncthreads(self, rank):
        self.local_dirty[rank].clear()

    def cluster_sync(self):
        for r in range(self.c):
            self.syncthreads(r)
        self.remote_dirty.clear()
        self.remote_read.clear()

    def read(self, plane, rank, dy, dx, fill):
        """Rows of ``rank`` of ``plane`` shifted by (dy, dx): out(y, x) =
        plane(y - dy, x - dx), ``fill`` outside the image; each source row
        from the CTA that owns it."""
        r0, nr = self.own(rank)
        sy = torch.arange(r0, r0 + nr) - dy
        xs = torch.arange(self.w) - dx
        ok = ((sy >= 0) & (sy < self.h))[:, None] & ((xs >= 0) & (xs < self.w))[None, :]
        for owner in sorted(set((sy[(sy >= 0) & (sy < self.h)] // self.rows).tolist())):
            if owner == rank:
                assert plane not in self.local_dirty[rank], f"{plane} read before the CTA barrier"
            else:
                assert (plane, owner) not in self.remote_dirty, f"{plane} of CTA {owner} read before the cluster barrier"
                self.remote_read.add((plane, owner))
        # Row sy is row sy - owner R of its owner's buffer: the buffers
        # stacked in rank order hold it at index sy.
        full = torch.cat(self.buf[plane])
        src = full[sy.clamp(0, self.h - 1)][:, xs.clamp(0, self.w - 1)]
        return torch.where(ok, src, bool(fill))

    def write(self, plane, rank, rows):
        for p, o in self.remote_read:
            assert not (p == plane and o == rank), f"{plane} of CTA {rank} written while another CTA may read it"
        self.buf[plane][rank][:rows.shape[0]] = rows
        self.local_dirty[rank].add(plane)
        self.remote_dirty.add((plane, rank))

    def run(self, dst, fn):
        """One pass: every CTA computes its rows of ``dst`` from reads made
        before any CTA writes (a pass never reads the plane it writes)."""
        outs = [fn(rank) for rank in range(self.c)]
        for rank, rows in enumerate(outs):
            self.write(dst, rank, rows)

    def gather(self, plane):
        return torch.cat([self.buf[plane][r][:self.own(r)[1]] for r in range(self.c)])


def split_model(m, e, ray, line, probe_len, rows):
    """One (H, W) bool mask through the split kernel's passes and barriers;
    ``ray`` (2, probe_len + 1, 2) and ``line`` (S, 2) its schedule."""
    h, w = m.shape
    cl = Cluster(h, w, rows)
    for rank in range(cl.c):                    # load and pack this CTA's rows
        r0, nr = cl.own(rank)
        cl.write("M", rank, m[r0:r0 + nr])
        cl.write("E", rank, e[r0:r0 + nr])
    cl.cluster_sync()
    tot = ray_totals(ray, probe_len)

    def ray_pass(rank):
        ended = []
        for s in range(2):
            c1 = c2 = torch.zeros(cl.own(rank)[1], w, dtype=torch.bool)
            for ty, tx in tot[s].tolist():
                v = cl.read("M", rank, -ty, -tx, 0)
                c2 = c2 | (c1 & v)
                c1 = c1 | v
            ended.append(c2)
        own_m, own_e = cl.read("M", rank, 0, 0, 0), cl.read("E", rank, 0, 0, 0)
        return own_m & own_e & ~(ended[0] & ended[1])

    cl.run("X", ray_pass)
    x, xn = "X", "Y"
    for dy, dx in line.tolist():
        if dy == 0 and dx == 0:                  # x | x | x: no pass
            continue
        cl.cluster_sync()
        cl.run(xn, lambda r: cl.read(x, r, 0, 0, 0) | cl.read(x, r, dy, dx, 0) | cl.read(x, r, -dy, -dx, 0))
        x, xn = xn, x
    for rank in range(cl.c):
        cl.syncthreads(rank)
    # G1 -> E (the ray pass's last reader of E was the CTA itself).
    cl.run("E", lambda r: cl.read(x, r, 0, 0, 0) | cl.read(x, r, 0, 1, 0) | cl.read(x, r, 0, -1, 0))
    cl.cluster_sync()
    grown = xn
    cl.run(grown, lambda r: cl.read("E", r, 0, 0, 0) | cl.read("E", r, 1, 0, 0) | cl.read("E", r, -1, 0, 0))
    for rank in range(cl.c):
        cl.syncthreads(rank)

    def e1_pass(r):
        def u(dx):
            return cl.read("M", r, 0, dx, 1) | cl.read(grown, r, 0, dx, 1)
        return u(0) & u(1) & u(-1)

    cl.run(x, e1_pass)
    cl.cluster_sync()
    cl.run("E", lambda r: cl.read("M", r, 0, 0, 0) | (
        cl.read(x, r, 0, 0, 0) & cl.read(x, r, 1, 0, 1) & cl.read(x, r, -1, 0, 1) & cl.read(grown, r, 0, 0, 0)))
    for rank in range(cl.c):
        cl.syncthreads(rank)
    return cl.gather("E")


def split_bridge(masks, exps, angles, kernel_len, probe_len, max_kernel, rows):
    """The model over an (N, H, W) batch, one cluster per mask."""
    ray, line = tf.bridge_schedule(angles, kernel_len, probe_len, max_kernel)
    return torch.stack([split_model(masks[i], exps[i], ray[i], line[i], probe_len, rows)
                        for i in range(masks.shape[0])])


def _lines(n, h, w, angles, seed):
    """(n, h, w) bool: broken 2-px lines at the given angles plus pixels on
    all four borders (the shifts' zero fill and the erosion's one fill), and
    expandability images."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.zeros((n, h, w), bool)
    for i in range(n):
        a = angles[i % len(angles)]
        d = (xx - w / 2) * math.sin(a) - (yy - h / 2) * math.cos(a)
        al = (xx - w / 2) * math.cos(a) + (yy - h / 2) * math.sin(a)
        m[i] = (np.abs(np.mod(d + rng.random() * 16, 13) - 6.5) < 1.0) & (np.abs(np.mod(al, 29) - 14.5) > 3)
    m[:, 0, ::3] = True
    m[:, -1, 1::4] = True
    m[:, ::5, 0] = True
    m[:, 2::3, -1] = True
    return torch.as_tensor(m), torch.as_tensor(rng.random((n, h, w)) < 0.8)


# Near-vertical lines (the v masks: the line reach runs along the rows),
# the axes, diagonals and angles whose rounding differs from step to step.
SWEEP = [math.pi / 2, 1.5707964, 1.45, -1.5, 1.62, 0.0, math.pi / 4, -0.7, 2.3, 3.0]


@pytest.mark.parametrize("probe_len, max_kernel", [(9, 251), (9, 361), (5, 125), (2, 125)])
@pytest.mark.parametrize("parts", [1, 2, 3, 5, 8])
def test_split_model_equals_plain(parts, probe_len, max_kernel):
    """1-8 parts of H = 90 rows (R = 90, 45, 30, 18, 12: the line steps of
    up to 125-180 rows cross many CTAs, R below the ray's reach at 8 parts),
    W = 70 (off 32), kernel lengths from 0 past the cap."""
    n, h, w = len(SWEEP), 90, 70
    m, e = _lines(n, h, w, SWEEP, parts + probe_len)
    ang = torch.tensor(SWEEP)
    kl = torch.tensor([0.0, 20.0, 90.0, 160.0, 400.0])
    got = split_bridge(m, e, ang, kl, probe_len, max_kernel, -(-h // parts))
    assert torch.equal(got, tf.bridge_morphology_plain(m, e, ang, kl, probe_len, max_kernel))


@pytest.mark.parametrize("rows", [1, 4, 7, 13, 17])
def test_split_model_rows_off_the_height(rows):
    """R that does not divide H = 53 (the last CTA keeps fewer rows), R of 1
    row, 53 masks' worth of parts; probe 9 at max kernel 251."""
    n, h, w = 4, 53, 40
    m, e = _lines(n, h, w, SWEEP[:4], rows)
    ang = torch.tensor(SWEEP[:4])
    kl = torch.tensor(300.0)
    got = split_bridge(m, e, ang, kl, 9, 251, rows)
    assert torch.equal(got, tf.bridge_morphology_plain(m, e, ang, kl, 9, 251))


@pytest.mark.parametrize("probe_len", [1, 3, 6, 7, 8, 16, 33, 64])
def test_ray_totals_equal_the_doubling(probe_len):
    """The ray counts from the totals equal the plain version's doubling at
    every probe length's bit pattern, on random masks with pixels against
    every border: count(y) = sum of m(y + T) over the totals, 0 where y + T
    leaves the image (the doubling's intermediate shifts lie between y and
    y + T, since each direction's offsets share their signs)."""
    n, h, w = len(SWEEP), 40, 50
    rng = np.random.default_rng(probe_len)
    m = torch.as_tensor(rng.random((n, h, w)) < 0.3)
    ang = torch.tensor(SWEEP)
    ray, _ = tf.bridge_schedule(ang, torch.tensor(0.0), probe_len, 5)
    mf = m.to(torch.float32)
    for i in range(n):
        tot = ray_totals(ray[i], probe_len)
        for s in range(2):
            d = ray[i:i + 1, s]
            pows = {1: tf.shift2d(mf[i:i + 1], -d[:, 1, 0], -d[:, 1, 1])}
            p = 1
            while 2 * p <= probe_len:
                pows[2 * p] = pows[p] + tf.shift2d(pows[p], -d[:, p, 0], -d[:, p, 1])
                p *= 2
            want, off = torch.zeros_like(mf[i:i + 1]), 0
            for b in reversed(range(probe_len.bit_length())):
                if probe_len >> b & 1:
                    want = want + tf.shift2d(pows[1 << b], -d[:, off, 0], -d[:, off, 1])
                    off += 1 << b
            got = torch.zeros_like(want)
            for ty, tx in tot[s].tolist():
                got = got + tf.shift2d(mf[i:i + 1], torch.tensor([-ty]), torch.tensor([-tx]))
            assert torch.equal(got, want)


def test_model_catches_a_missing_barrier():
    """The model refuses a remote read of rows written since the last
    cluster barrier."""
    cl = Cluster(10, 8, 5)
    cl.write("M", 0, torch.ones((5, 8), dtype=torch.bool))
    with pytest.raises(AssertionError, match="cluster barrier"):
        cl.read("M", 1, 5, 0, 0)
    cl.cluster_sync()
    assert bool(cl.read("M", 1, 5, 0, 0).all())
    with pytest.raises(AssertionError, match="written while"):
        cl.write("M", 0, torch.zeros((5, 8), dtype=torch.bool))
