"""PyTorch port, on the CPU: a numpy model of the CC kernel's capped scans
by segmented block minima (``csrc/connected_components.cu``: ``bm_chunk``,
``capped_row_pass``, ``capped_row``, and ``capped_column_stream`` over
``cc_capped_cols_stream``'s strips; past one pass's reach the walk,
``capped_min``), kept in this file, held to the port's
``_seg_min_scan_roll`` and ``connected_components_plain`` and to the JAX
package's ``_seg_min_scan_roll`` (in Pallas interpret mode).

The scheme: with reach r = 2^k - 1, every in-mask pixel j of a line takes
the minimum over its run within [j - r, j + r], as the minimum of the
one-sided windows [j - r, j] and [j, j + r].  Blocks of L = r + 1 pixels,
aligned on multiples of L, carry a forward minimum P that restarts at each
run start and a backward minimum S that restarts at each run end, each with
a flag "reaches the block's start (end)".  Then

    left(j)  = P[j], joined if P[j] reaches its block start with S[j - r]
               where that reaches its block end, else with P[start - 1];
    right(j) = S[j], joined if S[j] reaches its block end with P[j + r]
               where that reaches its block start, else with S[end + 1],

pixels past the line being background.  The models follow the kernels:
rows by a warp, a lane a pixel, 32-pixel chunks, scans of log2 L shuffle
steps within a block, results written after the next chunk is read, up to
reach 31; columns by a thread over a strip of rows and the reach above and
below it, streamed with P and S of three blocks at a time, up to reach 15.
Past those reaches each in-mask pixel walks its run.  The capped calls take
the CC kernel's band route at every size.  No CUDA here:
tests/test_torch_cuda.py holds the kernels to the plain versions on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cylinder_pose_estimation_tpu.ops.pallas import frontend as jf
from cylinder_pose_estimation_tpu_torch.ops import frontend as tf

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

FLAG = 1 << 31
CAPS = (1, 2, 3, 10, 16, 64)


def _val(e):
    return e & ~FLAG


def _reaches(e):
    return bool(e & FLAG)


def _step(v, edge, big, state):
    """bm_step: one P or S step; ``state`` = [running minimum, flag]."""
    if edge:
        state[0], state[1] = big, True
    if v == big:
        state[0], state[1] = big, False
        return big
    state[0] = min(state[0], v)
    return state[0] | (FLAG if state[1] else 0)


def _combine(pj, sj, s_back, p_prev, p_fwd, s_next):
    """bm_combine."""
    left, right = _val(pj), _val(sj)
    if _reaches(pj):
        left = min(left, _val(s_back) if _reaches(s_back) else _val(p_prev))
    if _reaches(sj):
        right = min(right, _val(p_fwd) if _reaches(p_fwd) else _val(s_next))
    return min(left, right)


# --------------------------------------------------------------------------
# Rows: capped_row (a warp per row, a lane per pixel)
# --------------------------------------------------------------------------


def _chunk(row, x0, big, log_l):
    """bm_chunk: P and S of the 32 lanes of the chunk at x0 by segmented
    scans within blocks of L lanes (shuffles of width L: a lane whose source
    lies outside its block reads its own value)."""
    L = 1 << log_l
    n = len(row)
    v = [int(row[x0 + ln]) if x0 + ln < n else big for ln in range(32)]
    m = [x != big for x in v]

    def all_in(lo, hi):
        return all(m[lo:hi + 1])

    fwd, bwd = list(v), list(v)
    d = 1
    while d < L:
        up = [fwd[ln - d] if ln % L >= d else fwd[ln] for ln in range(32)]
        dn = [bwd[ln + d] if ln % L + d < L else bwd[ln] for ln in range(32)]
        for ln in range(32):
            b0 = ln & ~(L - 1)
            if ln - d >= b0 and all_in(ln - d, ln):
                fwd[ln] = min(fwd[ln], up[ln])
            if ln + d <= b0 + L - 1 and all_in(ln, ln + d):
                bwd[ln] = min(bwd[ln], dn[ln])
        d *= 2
    p, s = [], []
    for ln in range(32):
        b0 = ln & ~(L - 1)
        p.append(fwd[ln] | (FLAG if m[ln] and all_in(b0, ln) else 0))
        s.append(bwd[ln] | (FLAG if m[ln] and all_in(ln, b0 + L - 1) else 0))
    return p, s


def _row_pass(row, big, log_l):
    """capped_row_pass, in place on ``row``: the chunks before, at and after
    the one being finished, its entries by lane arithmetic."""
    L = 1 << log_l
    R = L - 1
    n = len(row)
    pp, sp = [big] * 32, [big] * 32
    pc, sc = _chunk(row, 0, big, log_l)
    for x0 in range(0, n, 32):
        pn, sn = _chunk(row, x0 + 32, big, log_l)
        outs = {}
        for ln in range(32):
            b0 = ln & ~(L - 1)
            s_back = sc[(ln - R) & 31] if ln >= R else sp[(ln - R) & 31]
            p_prev = pc[(b0 - 1) & 31] if b0 > 0 else pp[31]
            p_fwd = pc[(ln + R) & 31] if ln + R < 32 else pn[(ln + R) & 31]
            s_next = sc[(b0 + L) & 31] if b0 + L < 32 else sn[0]
            if x0 + ln < n and _val(pc[ln]) != big:
                outs[x0 + ln] = _combine(pc[ln], sc[ln], s_back, p_prev, p_fwd, s_next)
        for x, o in outs.items():
            row[x] = o
        pp, sp, pc, sc = pc, sc, pn, sn


def model_walk(line, reach, big):
    """capped_min: every in-mask pixel takes the minimum of its run's pixels
    at most ``reach`` steps away."""
    v = np.array([int(x) for x in line], dtype=np.int64)
    out = v.copy()
    n = len(v)
    for j in range(n):
        if v[j] == big:
            continue
        lo = j
        while lo > 0 and j - lo < reach and v[lo - 1] != big:
            lo -= 1
        hi = j
        while hi < n - 1 and hi - j < reach and v[hi + 1] != big:
            hi += 1
        out[j] = v[lo:hi + 1].min()
    return out


def model_row(line, reach, big):
    """capped_row up to reach 31 (one pass, blocks of reach + 1 lanes), the
    walk past it."""
    if reach > tf.CAPPED_ROW_REACH:
        return model_walk(line, reach, big)
    row = [int(x) for x in line]
    if reach > 0:
        _row_pass(row, big, (reach + 1).bit_length() - 1)
    return np.array(row, dtype=np.int64)


# --------------------------------------------------------------------------
# Columns: capped_column_stream (a thread per column over a strip of rows)
# --------------------------------------------------------------------------


def model_stream(line, reach, big, rows):
    """capped_column_stream over strips of ``rows`` rows (the band route's
    column pass up to reach 15): each strip's column streams block by block
    through P and S of the blocks before, at and after the one being
    finished, the input past [y0 - reach, y1 + reach) read as background;
    the entries by their constant offsets in those blocks."""
    n = len(line)
    L = reach + 1
    out = np.array([int(x) for x in line], dtype=np.int64)

    for y0 in range(0, n, rows):
        y1 = min(y0 + rows, n)
        a0, a1 = max(y0 - reach, 0), min(y1 + reach, n)

        def scan(k):
            v = [int(line[y]) if a0 <= y < a1 else big for y in range(k * L, k * L + L)]
            st = [big, True]
            p = [_step(x, False, big, st) for x in v]
            st = [big, True]
            s = [_step(x, False, big, st) for x in v[::-1]][::-1]
            return p, s

        s_prev, p_prev_end = [big] * L, big
        k0, k1 = y0 // L, (y1 - 1) // L
        if k0 > 0 and k0 * L > a0:
            p_tmp, s_prev = scan(k0 - 1)
            p_prev_end = p_tmp[L - 1]
        p_cur, s_cur = scan(k0)
        for k in range(k0, k1 + 1):
            p_next, s_next = scan(k + 1)
            for t in range(L):
                j = k * L + t
                if y0 <= j < y1 and _val(p_cur[t]) != big:
                    out[j] = _combine(p_cur[t], s_cur[t], s_cur[0] if t == L - 1 else s_prev[t + 1], p_prev_end,
                                      p_cur[L - 1] if t == 0 else p_next[t - 1], s_next[0])
            p_prev_end, s_prev, p_cur, s_cur = p_cur[L - 1], s_cur, p_next, s_next
    return out


def model_columns(line, reach, big, rows):
    """The column pass along H: streamed over strips of ``rows`` rows up to
    reach 15, the walk past it."""
    if reach > tf.CAPPED_STREAM_REACH:
        return model_walk(line, reach, big)
    return model_stream(line, reach, big, rows)


# --------------------------------------------------------------------------
# Reference: the port's plain scan on lines with background ends (the CC's
# ring), and the lines the tests use
# --------------------------------------------------------------------------


def plain_scan(lines, big, cap):
    """``tf._seg_min_scan_roll`` along each row of ``lines`` (background
    ``big``) with the CC's masking."""
    lab = torch.as_tensor(lines, dtype=torch.int64)
    maskf = (lab != big).to(torch.float32)
    out = tf._seg_min_scan_roll(lab, maskf, 1, lab.shape[1], cap)
    return torch.where(lab != big, out, big).numpy()


def make_lines(kind, n, count, seed):
    """``count`` lines of n pixels, background at both ends (the ring)."""
    rng = np.random.default_rng(seed)
    big = 10_000
    lab = rng.integers(0, big, (count, n))
    if kind == "random":
        keep = rng.random((count, n)) < rng.uniform(0.2, 0.95, (count, 1))
    elif kind == "all_in":
        keep = np.ones((count, n), dtype=bool)
    elif kind == "all_background":
        keep = np.zeros((count, n), dtype=bool)
    elif kind == "long_runs":
        keep = np.ones((count, n), dtype=bool)
        for i in range(count):  # a few gaps: runs longer than most blocks
            keep[i, rng.integers(0, n, rng.integers(0, 3))] = False
    else:  # "edges": runs starting and ending at block, chunk and strip edges
        keep = np.zeros((count, n), dtype=bool)
        for i in range(count):
            for a, b in ((1, 8), (15, 33), (31, 65), (64, 97), (7, 17), (32, 40)):
                lo, hi = a + i % 3, b - i % 2
                keep[i, lo:hi] = True
    keep[:, 0] = keep[:, -1] = False
    return np.where(keep, lab, big), big


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------


def test_cap_reach_is_a_power_of_two_minus_one():
    """The blocks are reach + 1 pixels, cut with masks: every reach is
    2^k - 1."""
    for n in range(1, 300):
        for cap in range(1, 300):
            r = tf.cap_reach(n, cap)
            if r >= 0:
                assert r & (r + 1) == 0 and r < n - 1


@pytest.mark.parametrize("kind", ["random", "all_in", "all_background", "long_runs", "edges"])
@pytest.mark.parametrize("cap", CAPS)
def test_models_equal_the_plain_scan(cap, kind):
    """Lines of 1 to 97 pixels (not multiples of a block, reach at least the
    line included): the row model, and the column passes over one strip and
    over strips of 1, 3, 7, 16, 5, 32 and 64 rows (reach past a strip's
    rows) equal the plain capped scan."""
    for n in range(1, 98):
        lines, big = make_lines(kind, n, 3, seed=n * 100 + cap)
        want = plain_scan(lines, big, cap)
        reach = tf.cap_reach(n, cap)
        for i, line in enumerate(lines):
            if reach < 0:  # the cap covers every run: the plain full scan
                assert (plain_scan(lines[i:i + 1], big, 0)[0] == want[i]).all()
                continue
            assert (model_row(line, reach, big) == want[i]).all(), (n, reach, "row")
            for rows in (n, 1, 3, 7, 16, 5, 32, 64):
                assert (model_columns(line, reach, big, rows) == want[i]).all(), (n, reach, rows, "columns")


@pytest.mark.parametrize("reach", [1, 3, 7, 15, 31, 63, 127, 255])
def test_models_at_long_reaches(reach):
    """Around one pass's reach (15 along H, 31 along W) and past it, where
    the kernels walk: the row and column models equal the plain capped scan
    on long runs at every line length around the blocks and strips of 64
    rows."""
    for n in (reach + 2, reach + 3, 2 * reach + 1, 200, 257):
        lines, big = make_lines("long_runs", n, 4, seed=reach + n)
        want = plain_scan(lines, big, reach + 1)
        for i, line in enumerate(lines):
            assert (model_row(line, reach, big) == want[i]).all(), (reach, n, "row")
            assert (model_columns(line, reach, big, 64) == want[i]).all(), (reach, n, "columns")


def _jax_scan(lab, maskf, axis, cap):
    n = lab.shape[axis]

    def kernel(l_ref, m_ref, o_ref):
        o_ref[...] = jf._seg_min_scan_roll(l_ref[...], m_ref[...], axis, n, cap)

    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(lab.shape, jnp.int32), interpret=True)(
        jnp.asarray(lab, jnp.int32), jnp.asarray(maskf, jnp.float32))
    return np.asarray(out)


@pytest.mark.parametrize("cap", CAPS)
def test_models_equal_the_jax_scan(cap):
    """The JAX package's _seg_min_scan_roll (Pallas interpret mode) along
    both axes of masks with a background ring: the row model along W, the
    column passes over strips of several heights along H."""
    rng = np.random.default_rng(cap)
    for h, w in ((24, 97), (97, 24), (40, 33)):
        big = h * w
        keep = rng.random((h, w)) < 0.7
        keep[h // 3, :] = True  # one long run along W
        keep[:, w // 3] = True  # and along H
        keep[0, :] = keep[-1, :] = keep[:, 0] = keep[:, -1] = False
        lab = np.where(keep, rng.permutation(h * w).reshape(h, w), big)
        for axis in (0, 1):
            want = np.where(keep, _jax_scan(lab, keep.astype(np.float32), axis, cap), big)
            n = lab.shape[axis]
            reach = tf.cap_reach(n, cap)
            lines = lab if axis == 1 else lab.T
            wl = want if axis == 1 else want.T
            if reach < 0:
                assert (plain_scan(lines, big, 0) == wl).all()
                continue
            for i, line in enumerate(lines):
                if axis == 1:
                    assert (model_row(line, reach, big) == wl[i]).all(), (h, w, i)
                else:
                    for rows in (-(-n // 4), 32, 7, 64):
                        assert (model_columns(line, reach, big, rows) == wl[i]).all(), (h, w, i, rows)


def _cc_model(mask, rounds, pools, init, cap_axis, cap, rows):
    """connected_components_plain's schedule in numpy with the capped axis
    through the models (rows: capped_row; columns: the column passes over
    strips of ``rows`` rows)."""
    h, w = mask.shape
    big = h * w
    ring = np.zeros((h, w), dtype=bool)
    ring[1:-1, 1:-1] = True
    m = (mask > 0.5) & ring
    idx = np.arange(h * w).reshape(h, w)
    lab = np.where(m, idx if init is None else np.minimum(init, idx), big)
    reach = tf.cap_reach((h, w)[cap_axis], cap)

    def full(lines):
        return plain_scan(lines, big, 0)

    for _ in range(rounds):
        for _ in range(pools):
            out = lab.copy()
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
                out = np.minimum(out, np.roll(np.roll(lab, dy, 0), dx, 1))
            lab = np.where(m, out, big)
        if cap_axis == 1 and reach >= 0:
            lab = np.stack([model_row(r, reach, big) for r in lab])
        else:
            lab = full(lab)
        if cap_axis == 0 and reach >= 0:
            lab = np.stack([model_columns(c, reach, big, rows) for c in lab.T]).T
        else:
            lab = full(lab.T).T
    return lab


@pytest.mark.parametrize("cap_axis", [0, 1])
@pytest.mark.parametrize("cap", CAPS)
def test_cc_with_the_models_equals_plain(cap_axis, cap):
    """The whole round schedule, cold and warm, with the capped axis through
    the models, equals connected_components_plain(cap_axis=...); along H
    over strips of 10 rows (reach past them from cap 16 on), 32 and 64 (the
    kernel's)."""
    rng = np.random.default_rng(10 * cap + cap_axis)
    h, w = 44, 70
    mask = (rng.random((h, w)) < 0.55).astype(np.float32)
    mask[10:13, 3:67] = 1  # a line along W
    mask[3:41, 30:32] = 1  # and along H
    init = rng.integers(0, 2 * h * w, (h, w))
    for rounds, pools in ((1, 2), (2, 2), (3, 1)):
        for start in (None, init):
            want = tf.connected_components_plain(
                torch.as_tensor(mask)[None], rounds, pools,
                None if start is None else torch.as_tensor(start, dtype=torch.int32)[None], cap_axis, cap)[0]
            for rows in (10, 32, 64):
                got = _cc_model(mask, rounds, pools, start, cap_axis, cap, rows)
                assert (got == want.numpy()).all(), (rounds, pools, rows)
