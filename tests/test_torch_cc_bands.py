"""PyTorch port, on the CPU: a model of the CC family's large-frame route
(``csrc/connected_components.cu`` ``cc_band`` and ``cc_fix``) kept in this
file, held to the plain versions.  The model follows the kernels' steps:
each band loads its rows of the exact state with a halo of ``pools`` rows,
runs Jacobi pools whose first and last loaded rows keep their loaded
values, the row runs and its own column runs, and writes the edge tables
(per column the extreme of the runs touching the band's top and bottom and
their lengths); the fix walks the other bands' entries and rewrites each
band's edge runs from the tables.  No JAX here: the plain versions are the
port's own (``tests/test_torch_kernels.py`` holds them to the Pallas
kernels)."""

import numpy as np
import pytest
import torch

from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

COMB = (torch.minimum, torch.maximum)


def _bands(h, band_rows):
    return [(y0, min(band_rows, h - y0)) for y0 in range(0, h, band_rows)]


def band_column_runs(lab, m, band_rows, c, bg):
    """cc_band's column pass on (N, H, W) values ``lab`` (background ``bg``
    off the (N, H, W) bool mask ``m``): every band's column runs, walked down
    and back, and the edge tables.  Returns (values, vals (N, bands, 2, W),
    lens (N, bands, 2, W)); side 0 is the top edge, 1 the bottom."""
    comb = COMB[c]
    out = lab.clone()
    bands = _bands(lab.shape[1], band_rows)
    n, _, w = lab.shape
    vals = torch.empty((n, len(bands), 2, w), dtype=lab.dtype)
    lens = torch.empty((n, len(bands), 2, w), dtype=torch.int64)
    for b, (y0, nr) in enumerate(bands):
        seg = m[:, y0:y0 + nr]
        for order in (range(nr), range(nr - 1, -1, -1)):
            run = torch.full((n, w), bg, dtype=lab.dtype)
            for ly in order:
                run = torch.where(seg[:, ly], comb(run, out[:, y0 + ly]), bg)
                out[:, y0 + ly] = torch.where(seg[:, ly], run, out[:, y0 + ly])
        vals[:, b, 0] = out[:, y0]
        vals[:, b, 1] = out[:, y0 + nr - 1]
        lens[:, b, 0] = torch.cumprod(seg.to(torch.int64), 1).sum(1)
        lens[:, b, 1] = torch.cumprod(seg.flip(1).to(torch.int64), 1).sum(1)
    return out, vals, lens


def band_fix(out, vals, lens, band_rows, c, bg):
    """cc_fix: per band and column, the carries from the bands above (below)
    while their edge pixels stay in the mask, past bands that are one run,
    written over the band's edge runs from the tables."""
    comb = COMB[c]
    out = out.clone()
    bands = _bands(out.shape[1], band_rows)
    full = torch.full(out[:, 0].shape, bg, dtype=out.dtype)
    for b, (y0, nr) in enumerate(bands):
        top, bot = lens[:, b, 0], lens[:, b, 1]
        up, alive = full.clone(), top > 0
        for r in range(b - 1, -1, -1):
            alive = alive & (lens[:, r, 1] > 0)
            up = torch.where(alive, comb(up, vals[:, r, 1]), up)
            alive = alive & (lens[:, r, 0] == bands[r][1])
        dn, alive = full.clone(), bot > 0
        for r in range(b + 1, len(bands)):
            alive = alive & (lens[:, r, 0] > 0)
            dn = torch.where(alive, comb(dn, vals[:, r, 0]), dn)
            alive = alive & (lens[:, r, 1] == bands[r][1])
        one = top == nr
        v_top = torch.where(one, comb(vals[:, b, 0], comb(up, dn)), comb(vals[:, b, 0], up))
        v_bot = comb(vals[:, b, 1], dn)
        for ly in range(nr):
            row = out[:, y0 + ly]
            row = torch.where(ly >= nr - bot, v_bot, row)
            out[:, y0 + ly] = torch.where(ly < top, v_top, row)
    return out


def _pool(state, m, c, bg):
    """One masked 3x3 pool (the plain version's) of a whole plane."""
    comb = COMB[c]
    out = state
    for dy, dx in tf._NEIGHBOURS:
        out = comb(out, torch.roll(state, (dy, dx), (1, 2)))
    return torch.where(m, out, bg)


def band_round(states, m, band_rows, pools, bgs):
    """One round of the band route: cc_band over every band (halo loads of
    the exact ``states``, one per channel, Jacobi pools in the band's
    buffers, row runs, band column runs, edge tables), then cc_fix."""
    n, h, w = m.shape
    maskf = m.to(torch.float32)
    scans = (tf._seg_min_scan_roll, tf._seg_max_scan_roll)
    local = [s.clone() for s in states]
    for y0, nr in _bands(h, band_rows):
        ly0, ly1 = max(y0 - pools, 0), min(y0 + nr + pools, h)
        bufs = [s[:, ly0:ly1].clone() for s in states]
        ms = m[:, ly0:ly1]
        for _ in range(pools):
            nxt = []
            for c, buf in enumerate(bufs):
                pooled = buf.clone()
                inner = buf[:, 1:-1]
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        nb = torch.roll(buf, dx, 2)[:, 1 + dy:buf.shape[1] - 1 + dy]
                        inner = COMB[c](inner, nb)
                pooled[:, 1:-1] = torch.where(ms[:, 1:-1], inner, buf[:, 1:-1])
                nxt.append(pooled)
            bufs = nxt
        lo = y0 - ly0
        for c, buf in enumerate(bufs):
            band = buf[:, lo:lo + nr]
            band = torch.where(m[:, y0:y0 + nr], scans[c](band, maskf[:, y0:y0 + nr], 2, w), bgs[c])
            local[c][:, y0:y0 + nr] = band
    out = []
    for c, loc in enumerate(local):
        cols, vals_c, lens_c = band_column_runs(loc, m, band_rows, c, bgs[c])
        out.append(band_fix(cols, vals_c, lens_c, band_rows, c, bgs[c]))
    return out


def band_schedule(m, starts, rounds, pools, band_rows, fused=True):
    """The whole global route's schedule: fused, the pools inside the band
    rounds; unfused, as whole-plane passes before each band round."""
    h, w = m.shape[1:]
    bgs = (h * w, -1)
    states = list(starts)
    for _ in range(rounds):
        if not fused:
            for _ in range(pools):
                states = [_pool(s, m, c, bgs[c]) for c, s in enumerate(states)]
        states = band_round(states, m, band_rows, pools if fused else 0, bgs)
    return states


def _masks(n, h, w, seed, band_rows):
    """Random masks plus the structures that stress the bands: a full-height
    column, runs ending on band edges, one-pixel gaps on band edges, and a
    serpentine across bands; the 1-px ring is cleared as the kernels force."""
    rng = np.random.default_rng(seed)
    m = rng.random((n, h, w)) < 0.45
    m[0, :, 3] = True
    for y0 in range(band_rows, h, band_rows):
        m[0, y0 - 3:y0, 6] = True
        m[0, y0:y0 + 2, 6] = False
        m[0, :, 8] = True
        m[0, y0, 8] = False
        m[0, y0 - 1, 9] = False
    m[1] = False
    for y in range(2, h - 2, 3):
        m[1, y, 2:w - 2] = True
        m[1, y:y + 3, w - 3 if (y // 3) % 2 == 0 else 2] = True
    ring = np.zeros((h, w), bool)
    ring[1:h - 1, 1:w - 1] = True
    return torch.as_tensor(m & ring)


H, W = 37, 23


@pytest.mark.parametrize("c", [0, 1])
@pytest.mark.parametrize("band_rows", [1, 2, 3, 5, 8, 32, H - 1, H])
def test_band_column_runs_equal_segmented_scan(band_rows, c):
    """Per-band column runs, the edge tables and the fix give every in-mask
    pixel the extreme of its whole column run: ``_seg_min_scan_roll`` (c 0)
    or ``_seg_max_scan_roll`` (c 1) along dim 1."""
    m = _masks(3, H, W, band_rows, band_rows)
    rng = np.random.default_rng(100 + band_rows)
    bg = H * W if c == 0 else -1
    lab = torch.where(m, torch.as_tensor(rng.integers(0, H * W, m.shape), dtype=torch.int32), bg)
    cols, vals, lens = band_column_runs(lab, m, band_rows, c, bg)
    got = band_fix(cols, vals, lens, band_rows, c, bg)
    scan = (tf._seg_min_scan_roll, tf._seg_max_scan_roll)[c]
    want = torch.where(m, scan(lab, m.to(torch.float32), 1, H), bg)
    assert torch.equal(got, want)
    # The full-height column is one run across every band.
    assert int(got[0, 1:H - 1, 3].unique().numel()) == 1


SCHEDULES = [(2, 2), (2, 4), (3, 2), (1, 0)]


@pytest.mark.parametrize("band_rows", [1, 4, 8, 20])
@pytest.mark.parametrize("start", ["cold", "warm", "payload"])
@pytest.mark.parametrize("rounds, pools", SCHEDULES)
def test_band_schedule_equals_plain(rounds, pools, start, band_rows):
    """The fused schedule (pools inside the band rounds, through halos of
    ``pools`` rows) equals ``connected_components_plain`` cold and warm and
    ``component_payload_minmax_plain``, with bands shorter than, equal to and
    longer than the halo."""
    n, h, w = 3, 30, 26
    m = _masks(n, h, w, rounds * 10 + pools, band_rows)
    rng = np.random.default_rng(band_rows + 7 * pools)
    big = h * w
    idx = torch.arange(big, dtype=torch.int32).reshape(h, w)
    if start == "payload":
        pay = torch.as_tensor(np.stack([rng.permutation(big) for _ in range(n)]).reshape(n, h, w),
                              dtype=torch.int32)
        starts = [torch.where(m, pay, big), torch.where(m, pay, -1)]
        want = tf.component_payload_minmax_plain(m.to(torch.float32), pay, rounds, pools)
    else:
        init = None
        if start == "warm":
            init = torch.as_tensor(rng.integers(0, 2 * big, (n, h, w)), dtype=torch.int32)
        starts = [torch.where(m, idx if init is None else torch.minimum(init, idx), big)]
        want = (tf.connected_components_plain(m.to(torch.float32), rounds, pools, init),)
    got = band_schedule(m, starts, rounds, pools, band_rows)
    for a, b in zip(got, want):
        assert torch.equal(a.to(torch.int32), b)


@pytest.mark.parametrize("rounds, pools", SCHEDULES)
def test_unfused_band_schedule_equals_plain(rounds, pools):
    """The very wide masks' variant: whole-plane pools, then band rounds
    with no halo."""
    n, h, w = 2, 33, 29
    m = _masks(n, h, w, pools, 6)
    idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    got = band_schedule(m, [torch.where(m, idx, h * w)], rounds, pools, 6, fused=False)
    assert torch.equal(got[0].to(torch.int32), tf.connected_components_plain(m.to(torch.float32), rounds, pools))


def test_serpentine_stays_unconverged_across_bands():
    """The round schedule is exact: a serpentine across bands keeps more
    than one label after 2 rounds, in the model as in the plain version."""
    n, h, w = 2, 30, 26
    m = _masks(n, h, w, 0, 4)
    idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    got = band_schedule(m, [torch.where(m, idx, h * w)], 2, 2, 4)[0]
    assert torch.equal(got.to(torch.int32), tf.connected_components_plain(m.to(torch.float32), 2, 2))
    assert int(got[1][m[1]].unique().numel()) > 1
