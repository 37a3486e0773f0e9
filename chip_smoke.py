#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc``; exits non-zero without them, and when any
phase fails.  The first line, printed before anything that can fail, gives
the python, torch and CUDA versions.  Device kernels per call and their
device ms come from a CUDA graph captured from one call
(``utils.profiling.graph_kernels``); torch.profiler gives only the split by
kernel name.  Phases:

1. Build the CUDA kernels from ``cylinder_pose_estimation_tpu_torch/csrc``
   (first use; the library lands in the package's ``_build/``).
2. Main path: ``estimate_poses_batch`` on the bench scene family's six golden
   scenes plus the bridged gap scene (480x640), with every kernel launch
   counter reset just before and read just after; each scene is held against
   ``tests/fixtures/golden_scenes.json`` (ids identical, xy within 0.05 px,
   fit params within 0.05, reprojection within 0.01 px).
3. Endpoint path: the same seven scenes with
   ``CylinderDetectConfig(bridge_endpoint_stats=True)``, counters reset just
   before and read just after (the payload min/max kernel replaces the
   pre-bridge CC: ``connected_components`` runs twice), held to
   ``tests/fixtures/torch_endpoint_scenes.json`` by the same contract.
4. Plane path: ``detect_grid`` with ``PlaneDetectConfig(roi_threshold=30)``
   on the eight views that ``tests/fixtures/torch_plane_scenes.json``
   specifies, rendered here, counters reset just before and read just after;
   ids identical, xy within 0.05 px, ``ok`` and ``stable`` equal.
5. Numerics: each path's bridge on the card and on the CPU from the same
   carved masks; the angle difference and the differing bridged pixels are
   printed (the fixtures above are the gate).
6. Kernels: each CUDA kernel against its plain PyTorch version on the same
   device, on the intermediates of B=16 runs (production shapes) and on
   seeded random inputs; every output must be ``torch.equal``.  Median times
   of both, with CUDA events around one call after warm-up; the device
   kernels per call (at most 3 for 2.1, exactly 1 for the others) and the
   device ms of a graph replay; the byte bound of each site
   (``kernels.min_bytes`` at 3.35 TB/s).  The bridge is timed on the
   detector's bool masks and, off the report, as float32; its in-kernel
   schedule must equal ``bridge_schedule`` on the card for 10^5 angles.
   The fit tail's SPD
   solve (``ops/linalg.solve_spd``, ``csrc/linalg.cu``) is held and timed
   the same way against ``solve_spd_plain`` at the three shapes of the
   solves a B=16 main-path call makes (``solve_phase``), and the XLA
   branch's CC (``ops/labeling.connected_components``, ``csrc/scan_cc.cu``)
   against ``connected_components_plain`` at the three sites of a B=16
   default-config call (``hold_sites``; 2 device kernels a round).  The build's
   ``-Xptxas -v`` lines and the launch plans are printed first.
7. End to end, for the paths no cell of the benchmark (``bench_h100/``)
   runs: ms/frame of B=16 frames and the detect-only split, for the
   endpoint path; the main and endpoint paths' bridge and grid stage ms;
   plane detect ms/view.
8. Registration: ``fit_cylinders_with_angles`` on the points of
   ``tests/fixtures/torch_registration.json`` (100 frames, one poisoned
   frame masked) against the JAX result recorded there; then the experiment
   path, ``full_experiment`` on 100 frames of ``registration_sequence``
   (480x640), counters reset just before and read just after, whose
   registration is recomputed on the CPU from the card's own points and
   must agree.  Both comparisons: predicted cylinder axes within 0.05 deg
   and 0.1 mm perpendicular offset, fval and the minimum JtJ eigenvalue
   within rel 1e-2, ``well_posed`` equal (the sequence's default swing is
   well posed).  Prints
   the healthy-frame count, fval0/fval, the minimum eigenvalue and the
   errors against the ground-truth T_Cam_AGV.
9. Preprocessing path: ``full_experiment(preprocess=True)`` on 16 distorted
   frames, counters reset just before and read just after;
   ``preprocess_stereo_batch`` on the card against the CPU port (max |d| <=
   1e-2 grey levels, pixels over 1e-3 counted), and detection of 2 of the
   preprocessed frames card vs CPU (ids identical, xy within 0.05 px);
   preprocessing ms/frame.
10. Stream path: ``estimate_poses_stream(chunk=64, compact=True,
   overlap=True)`` over 2,000 uint8 frames (16 scenes tiled with brightness
   offsets), counters reset just before and read just after; every chunk's
   summary must equal ``_summarize_batch(estimate_poses_batch(...))`` of
   the same 64 frames on the card, the padded tail included, and the same
   stream with ``overlap=False`` must equal the overlapped one.  Prints the
   ok count, the median reprojection and the peak device memory.
11. XLA path (the default ``use_pallas=False``, run after phase 4):
   ``estimate_poses_batch`` with ``CylinderDetectConfig()`` on the seven
   scenes of phase 2 with ``gap0`` (the XLA record) in place of
   ``gap0_pallas``, held to ``golden_scenes.json`` by the phase-2 contract
   (direction at the fixture's norm), then ``detect_grid`` with
   ``PlaneDetectConfig(roi_threshold=30)`` on the phase-4 views, held to
   their points, ``ok`` and ``stable_xla``; counters reset just before and
   read just after must show none of the front end's kernels or stencils,
   and the branch's CC (``scan_cc``).
12. Large path (run after phase 6): the main and endpoint configs at
   720x1280 and 1080x1920 on ``LARGE_BATCH`` frames each, counters reset
   just before and read just after (the CC family's global route and the
   bridge's split route); every kernel call there is captured and held
   ``torch.equal`` to its plain version on the card, with its ms, device
   ms and device ms by kernel name, device kernels per call (at most the
   global route's count, ``frontend.cc_global_launches``, and 1 for the
   bridge) and byte bound; the card's
   grids are held to the CPU port's (ids identical, xy within 0.05 px,
   ``ok`` and ``stable`` equal); ms/frame of each config and size.
13. Variants (run after phase 12): the configurations of
   ``tests/fixtures/torch_variant_scenes.json``'s 480x640 record
   (``subpixel_refine``, ``label_downsample=1`` and ``bridge_half_res=False``
   on both branches, the endpoint bridge at ``label_downsample=1``, plane
   mode at ``label_downsample=1`` on both branches) on B=16 frames of
   ``example_pair`` or the plane fixture's views; the kernel-branch and the
   XLA-branch configurations each a path with counters reset just before
   and read just after.  Every view is held to the JAX record (ids
   identical, xy within 0.05 px), 2 frames card against the CPU port; every
   kernel call at a full-resolution shape (the CC family's global route and
   the bridge's split route at (64, 480, 640) and (16, 480, 640)), and every
   call of the XLA configurations' CC (``scan_cc``), is held ``torch.equal``
   to its plain version and each site timed once; e2e and detect ms/frame
   per configuration.
14. CLI (run after phase 7): ``cli.main`` with ``--device cuda`` for
   ``detect-folder``, ``experiment`` (the record's arguments) and
   ``undistort-folder`` on PNG frames of ``write_registration_folder`` in a
   temporary directory, counters reset just before and read just after (the
   drivers' default config launches the XLA branch's CC alone); held to
   ``tests/fixtures/torch_cli.json`` (the JAX CLI on the same files) and the
   undistortion to the port on the CPU within one grey level.

15. Bridge routes (run after phase 13): ``frontend.bridge_morphology`` on
   line masks at one shape of each route of ``bridge_plan`` (cluster
   (64, 240, 384), split (2, 720, 1280) at full resolution, global
   (2, 2160, 3840): the 4K frame's full-resolution masks, past what 8 CTAs
   hold), counters reset just before and read just after: each route must
   launch; each call ``torch.equal`` to plain, its schedule equal to
   ``bridge_schedule``, timed.
16. Mesh path (run after phase 14): (a) ``parallel.sharding.sharded_pipeline``
   over a one-rank NCCL group (a ``FileStore``) on phase 8's 100 frames,
   counters reset just before and read just after: ids and ``ok`` equal to
   phase 8's unsharded result, the registration by phase 8's contract.
   (b) ``mesh_rank`` on MESH_RANKS_PER_CARD ranks sharing this card (gloo,
   the check mode), spawned by ``parallel.dryrun.launch``: every kernel call
   of ``sharded_pipeline`` on MESH_FRAMES main-path frames and of a
   two-chunk stream, at each rank's shapes, held ``torch.equal`` to its plain
   version; then the pipeline and the compact stream over
   MESH_STREAM_FRAMES frames at chunk 64, counters reset just before and
   read just after on every rank; rank 0 holds both to the unsharded run
   (``parallel.dryrun.held``: every leaf equal but the LM's outputs, which
   must meet the fit contract), frames 0-5 to the golden fixture and the
   registration to phase 8's contract.  Prints frames/s at 1 and 2 ranks,
   each rank's device kernels per detect step and its peak memory.  (c)
   With two cards or more, the same on 2 or 4 NCCL ranks, one per card.
17. Corpus path (run after phase 16): the JAX package's detection corpora
   (``corpus_phase``): the stability fence's lattices, rendered here, and
   the frames of ``tests/fixtures/torch_corpus_scenes.npz`` through both
   branches' entry points, the kernel branch with counters reset just
   before and read just after and every kernel call ``torch.equal`` to its
   plain version; card against the CPU port (ids identical, xy within 0.05
   px, ``ok`` and ``stable`` equal; in the chaotic window ``ok`` and
   ``stable`` only, the id-set differences printed), ms per view, and the
   numpy oracle of tests/_oracle_detect.py on the card's post-bridge state
   of golden scenes 0 and gap0_pallas (0.05 px).

18. Knobs (run after phase 17): the configurations of
   ``tests/fixtures/torch_knob_scenes.json``'s 480x640 record
   (``smooth_mxu=False``: the preprocess kernel's own smoothing;
   ``pallas_cc_cross_cap=16``: the final labels' capped scans, on the CC
   kernel's band route at the half-res canvas and, at
   ``label_downsample=1``, at full resolution;
   ``bright_at_points=False`` on both branches; the three together) through
   ``estimate_poses_batch`` on B=16 frames of ``example_pair``, each a path
   with counters reset just before and read just after and the launches of
   its one step checked (a capped step makes 4 CC calls, 2 of them capped).
   Every view is held to the JAX record (ids identical, xy within 0.05 px;
   ``ok``, ``stable`` and bridged counts printed against it), 2 frames card
   against the CPU port (ids, xy within 0.05 px, ``ok``/``stable`` flips
   counted).  The kernels' branches against their plain versions
   (``torch.equal``), timed: the smoothing at (32, 480, 640) and
   (4, 720, 1280) (three device kernels a call: the smoothing launch, then
   the pre-smoothed pair on its plane; the smoothing launch alone also
   against the four rolls), the capped scans at (32, 240, 384) and
   (32, 480, 640), both on the band route; e2e and detect ms/frame of
   each.

19. Compiled steps (run after phase 7): ``compiled_batch`` of the
   main, endpoint and XLA configs at B=16, of the main config at B=16 on
   1080x1920 pairs (``FULL_HD``: the CC family's band route, 8-CTA CC
   clusters and the bridge's split route inside the step), the registration
   step of ``register_sequence`` on phase 8's 100 frames and the stream's chunk step
   (``_stream_step``, compact, 64 frames), each against the eager call it
   replays: every leaf ``torch.equal`` (else the leaf, the count and the
   largest difference are printed and the phase fails), 0 host
   synchronisations per compiled call, the kernel nodes of the step's graph
   and its replay's device ms, the first call's time (eager) and the
   second's (warm-up, capture, replay) on their own, with the
   memory the device keeps reserved for the step after it (the graph's
   pool).  Each step's capture must record ``SOLVES_PER_CAPTURE`` kernel
   solves (``solve_spd``: 22 in a batch or chunk step, 141 in the
   registration) and ``SCAN_CC_PER_STEP`` launches of the XLA branch's CC
   in the default config's step (none in the others), printed with the
   step's kernel nodes with every solve the plain version and with the
   kernel; one line then gives every
   batch step's kernel nodes side by side.  Every kernel-wrapper call of
   the full-HD step's eager call is recorded and held ``torch.equal`` to
   its plain version on the same tensors, timed, with its byte bound (its
   sites join phase 12's in ``large_sites``).  The experiment, stream, mesh
   and CLI paths of phases 8-16 run through these steps too.

20. Stencils (run after phase 18): the front stage's banded correlations
   (``ops/stencils``: the smoothing ``stencil_smooth`` and the statistic
   images ``stencil_stats``) at the sites of the cells that run them
   (``STENCIL_SITES``: the views of a B=16 batch step, a 64-frame stream
   chunk and the F=100 experiment step at 480x640, a full-HD B=16 step, and
   the knob phase's centre-seed B=16 step), on the scene pools' frames and
   their preprocess intermediates, each held to the former banded matmuls
   or the phase fails: the smoothed plane within two float32 passes'
   rounding of sum |k| |k| |x|; the centroid images ``torch.equal``; the
   saturation blur before its threshold and the index blur within their
   bf16 pair's bound; the saturation mask equal but at ties (the matmuls'
   blur within that bound of the threshold); the centre box
   (``bright_at_points=False``) within two float32 passes' bound over its
   area.  Then ms per call, graph-replay device ms and device kernels per
   call, the byte bound (``kernels.min_bytes``), and the former matmul
   route's (the plain version's) ms and kernels on the card as the
   yardstick; the kernels line's ``stencil_smooth`` and ``stencil_stats``
   rows give the B=16 480x640 site's and list the others.  Then, on the
   480x640 and full-HD pools, the front stage and ``detect_grid`` by the
   kernel route and by the matmul route: the binary pixels, joint peaks,
   saturation-mask pixels, centroids, grid validity, ids and points and ok
   flags that differ, each of which must be 0.  One JSON line
   ``{"stencils": ...}``.

Launch counts.  The counters are the catalogue's (``ops/kernels``).  Every
path run (``run_path``, ``mesh_rank``) empties the compiled steps' cache
and zeroes the counters just before and reads them just after, so it
counts what a fresh process would launch.  A path's launches are the
kernels it ran on the card: each wrapper call outside a
capture, plus, for each replay of a compiled step, the wrapper calls its
capture recorded (``pipeline.graph_launch_counts``; a capture runs no
kernel and a replay calls no wrapper).  A one-shot path (experiment,
preprocess) is one eager call per step; the stream's first chunk is eager,
its second the warm-up before the capture and the first replay, every
later chunk a replay: one launch per chunk, and one more.  The kernels
line's ``launches`` sums these over the path runs; ``graph_replays`` gives
each path's replays.

The line before the card's name is phase 19's numbers as JSON.
The second-to-last line is the kernel report as JSON: one row per kernel
of the catalogue, with its source and the JAX code it replaces (the
480x640 sites; ``large_sites`` holds phase 12's and phase 19's
full-HD step's, ``variant_sites`` phase 13's), the bridge's cluster route in its own row and its split and
global routes in rows of their own (``bridge_morphology.split``,
``bridge_morphology.global``: their timed sites of phases 12, 13 and 15),
phase 18's kernel branches (``preprocess_binarize.smoothing``,
``connected_components.capped.band``) in rows of their own, the fit
tail's SPD solve (``solve_spd``, phase 6's sites), the front stage's
stencils (``stencil_smooth``, ``stencil_stats``: phase 20's B=16 480x640
site, its other sites in ``stencil_sites``), and the XLA branch's CC
(``scan_cc``: phase 6's three sites of the default B=16 step,
``variant_sites`` phase 13's XLA canvases).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "fixtures", "golden_scenes.json")
ENDPOINT = os.path.join(HERE, "tests", "fixtures", "torch_endpoint_scenes.json")
PLANE = os.path.join(HERE, "tests", "fixtures", "torch_plane_scenes.json")
REGISTRATION = os.path.join(HERE, "tests", "fixtures", "torch_registration.json")
VARIANTS = os.path.join(HERE, "tests", "fixtures", "torch_variant_scenes.json")
CLI_RECORD = os.path.join(HERE, "tests", "fixtures", "torch_cli.json")
CORPUS = os.path.join(HERE, "tests", "fixtures", "torch_corpus_scenes.npz")
KNOBS = os.path.join(HERE, "tests", "fixtures", "torch_knob_scenes.json")
# The numpy oracle of the reference's detection bookkeeping (numpy and scipy).
ORACLE = os.path.join(HERE, "tests", "_oracle_detect.py")
# Replays of compiled steps in each path run (``run_path``, ``mesh_rank``).
GRAPH_REPLAYS = {}
# Kernels each path must launch, by launch counter of the catalogue
# (``ops/kernels``): None, at least once; a number, exactly that often (0:
# never).  Filled by ``path_kernels`` when the checks start.
PATH_KERNELS = {}
# The knob phase (18): each configuration's path and its launches in one
# B=16 step (a number: exactly that often; None: at least once; absent: 0).
# The capped scans take the CC kernel's band route at every size.
_KNOB_MAIN = {"preprocess_binarize": 1, "connected_components": 3, "bridge_morphology": 1,
              "bridge_morphology.cluster": 1, "stencil_smooth": 1, "stencil_stats": 1, "solve_spd": None}
_KNOB_CAPPED = dict(_KNOB_MAIN, **{"connected_components": 4, "connected_components.band": 2,
                                   "connected_components.capped.band": 2})
KNOB_STEP = {
    "smoothing_kernel": dict(_KNOB_MAIN, **{"preprocess_binarize.smoothing": 1, "stencil_smooth": 0}),
    "cross_cap_kernel": _KNOB_CAPPED,
    "cross_cap_ds1_kernel": {"preprocess_binarize": 1, "connected_components": 4, "bridge_morphology": 1,
                             "bridge_morphology.split": None, "connected_components.band": None,
                             "connected_components.capped.band": 2, "stencil_smooth": 1, "stencil_stats": 1,
                             "solve_spd": None},
    "bright_kernel": _KNOB_MAIN,
    "bright_xla": {"solve_spd": None, "scan_cc": 3},
    "all_knobs_kernel": dict(_KNOB_CAPPED, **{"preprocess_binarize.smoothing": 1, "stencil_smooth": 0}),
}
# The kernel branches phase 18 adds to the kernels line, and the path whose
# step gives each one's launches per step.
KNOB_ROWS = {"preprocess_binarize.smoothing": "knobs.smoothing_kernel",
             "connected_components.capped.band": "knobs.cross_cap_kernel"}
# Frames of the knob phase, and of its card-versus-CPU checks.
KNOB_FRAMES, KNOB_CPU_FRAMES = 16, 2
# Kernel solves (``solve_spd``) one capture of each compiled step records:
# a batch or chunk step's 20 LM steps, its curvature and its grid stage's
# polyfit; the registration's 60 + 80 LM steps and its curvature.
SOLVES_PER_CAPTURE = {"batch": 22, "registration": 141}
# Launches of the XLA branch's CC kernel (``scan_cc``) in one batch step of
# the default config: the ROI pair, the bridge pair and the final labels
# (none in a kernel-branch step).
SCAN_CC_PER_STEP = 3
# The shape of each bridge route in phase 15.
ROUTE_SHAPES = {"bridge_morphology.cluster": (64, 240, 384), "bridge_morphology.split": (2, 720, 1280),
                "bridge_morphology.global": (2, 2160, 3840)}
# Frames of the variants phase (the fixture's 480x640 record) and of its
# card-versus-CPU checks.
VARIANT_FRAMES, VARIANT_CPU_FRAMES = 16, 2
# The full-HD batch step of phase 19: frame size and frames per call.
FULL_HD, FULL_HD_BATCH = (1080, 1920), 16
# The large path: frame sizes past the cluster kernels, frames per batch.
LARGE_SIZES = ((720, 1280), (1080, 1920))
LARGE_BATCH = 2
# The H100 SXM's HBM rate (NVIDIA data sheet) for the kernels' byte bounds.
HBM_BYTES_PER_S = 3.35e12
# Each kernel's design: redesigned for Hopper, or still the first port.
DESIGN = {"preprocess_binarize": "redesigned", "connected_components": "redesigned",
          "bridge_morphology": "redesigned", "component_payload_minmax": "redesigned",
          "bridge_morphology.split": "redesigned", "bridge_morphology.global": "first port",
          "preprocess_binarize.smoothing": "redesigned", "connected_components.capped.band": "redesigned",
          "solve_spd": "first port", "stencil_smooth": "redesigned", "stencil_stats": "redesigned",
          "scan_cc": "first port"}
# Device kernels of a preprocess call that smooths in the kernel: the
# smoothing launch, then launches A and B on its plane.
SMOOTHING_DEVICE_KERNELS = 3
# Device kernels one wrapper call may launch at the timed sites (the
# bridge's global route: frontend.bridge_global_launches).
DEVICE_LAUNCHES_MAX = {"preprocess_binarize": 3, "connected_components": 1, "bridge_morphology": 1,
                       "component_payload_minmax": 1, "bridge_morphology.split": 1,
                       "solve_spd": 5}  # the two launches and the plain residual's three kernels
# Angles of the bridge's in-kernel schedule check.
SCHEDULE_ANGLES = 100_000
# Sizes of the experiment, preprocessing and stream paths.
EXPERIMENT_FRAMES = 100
PREPROCESS_BATCH = 16
STREAM_FRAMES, STREAM_CHUNK, STREAM_POOL = 2000, 64, 16
# The mesh path (phase 16): frames of the sharded pipeline and of the
# sharded stream (at STREAM_CHUNK), and ranks that share the one card in the
# check mode.
MESH_FRAMES, MESH_STREAM_FRAMES, MESH_RANKS_PER_CARD = 16, 512, 2
# Turns of the mesh stream's timing: all ranks, then rank 0 alone, in
# alternating order.
MESH_TIMING_PAIRS = 3
# The corpus path (phase 17): the stability fence's lattices at 240x320
# (angle in degrees, noise seed), rendered here; from 26 degrees on the
# detector's labels are chaotic, and only ok and stable are compared there.
CORPUS_LATTICES = ((0.0, 0), (14.0, 0), (19.0, 0), (19.0, 1), (19.0, 2), (19.0, 3), (26.0, 0), (32.0, 0))
CORPUS_CHAOTIC = (26.0, 32.0)
# The front stage's stencils (phase 20): (cell or path, views, frame size,
# the configuration's knobs) of each site in the cells that run them, and
# of the knob phase's centre-seed path (the centre box); the site whose
# times the kernels line's stencil rows give; the pairs of each frame
# size's pool.
STENCIL_SITES = (("kernels.batch16", 32, (480, 640), {}), ("kernels.stream64", 128, (480, 640), {}),
                 ("kernels.experiment100", 200, (480, 640), {}), ("cyl1080-kernels.batch16", 32, (1080, 1920), {}),
                 ("knobs.bright_kernel", 2 * KNOB_FRAMES, (480, 640), {"bright_at_points": False}))
STENCIL_ROW_SITE = "kernels.batch16"
STENCIL_POOL = 16
# The fixture's 240x320 and 480x640 frames of the JAX corpora.
CORPUS_SMALL = ("gap3_control", "gap3_gapped", "double_gap", "indep2_240x320")
CORPUS_LARGE = ("indep1_480x640",)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of fn() by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    """The least time for moving ``nbytes`` at the H100 SXM's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_name(e) -> str:
    """A profiler event's kernel name without its arguments and namespace."""
    return e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")


def profiler_kernels(fn):
    """(CUDA kernels of one fn() call, their device ms by kernel name) from
    a torch.profiler session; (None, None) when it records none.  A session
    may lose the first kernels it sees, so a spin kernel
    (``torch.cuda._sleep``) leads the call and only what follows it counts.
    Late in a long process a session may record nothing at all: the
    kernels line's counts and device ms come from a captured CUDA graph
    (``profiling.graph_kernels``), and this gives only the breakdown by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()),
                    key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(events) if "spin" in e.name.lower()]
    events = events[spins[-1] + 1:] if spins else events
    by_name = {}
    for e in events:
        name = kernel_name(e)
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return (len(events), by_name) if events else (None, None)


def ptxas_report(build_dir) -> list:
    """The ``-Xptxas -v`` lines (registers, stack, spills) of each kernel in
    build.log, one line per kernel."""
    import re

    log = os.path.join(build_dir, "build.log")
    lines = open(log).read().splitlines() if os.path.exists(log) else []
    out, name = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            parts = [name]
        elif name and ("spill" in ln or "registers" in ln):
            parts.append(ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip())
            if "registers" in ln:
                out.append(" | ".join(parts))
                name = None
    return out


def grid_map(grid, i: int) -> dict:
    """{(id0, id1): xy} of view i of a GridPoints, on the host."""
    xy = grid.xy[i].cpu().numpy().astype("float64")
    idx = grid.idx[i].cpu().numpy()
    valid = grid.valid[i].cpu().numpy()
    return {(int(idx[k, 0]), int(idx[k, 1])): xy[k] for k in range(len(valid)) if valid[k]}


def points_check(grid, i: int, records: list, label: str):
    """View i of a GridPoints against fixture point records: ids identical,
    xy within 0.05 px.  Returns (number of points, max |dxy|)."""
    if not bool(grid.xy[i].isfinite().all()):
        raise AssertionError(f"{label}: non-finite grid coordinates")
    got = grid_map(grid, i)
    want = {tuple(r["id"]): (r["x"], r["y"]) for r in records}
    if set(got) != set(want):
        raise AssertionError(f"{label} id set differs: +{set(got) - set(want)} -{set(want) - set(got)}")
    max_d = 0.0
    for k, (x, y) in want.items():
        d = max(abs(got[k][0] - x), abs(got[k][1] - y))
        max_d = max(max_d, d)
        if d >= 0.05:
            raise AssertionError(f"{label} point {k}: {got[k]} vs fixture ({x}, {y})")
    return len(got), max_d


def golden_check(res, want: dict, s: int, gauge: bool = False) -> dict:
    """The golden-fixture contract for frame s of a StereoPoseResult.

    ``gauge``: compare the axis direction rescaled to the fixture's norm.
    The fit's objective does not see |direction|, so after 20 float32 LM
    steps its norm is noise-driven (ROADMAP section 3, fit gauge); the raw
    difference is reported beside it."""
    import numpy as np

    out = {"max_dxy": 0.0}
    for view, det in (("view1", res.detect1), ("view2", res.detect2)):
        out[f"n_{view}"], d = points_check(det.grid, s, want[view], view)
        out["max_dxy"] = max(out["max_dxy"], d)
    params = res.fit.params[s].cpu().numpy().astype(np.float64)
    if not np.all(np.isfinite(params)):
        raise AssertionError("non-finite fit params")
    ref = np.asarray(want["fit_params"])
    out["max_dparams_raw"] = float(np.max(np.abs(params - ref)))
    if gauge:
        params[3:] *= np.linalg.norm(ref[3:]) / np.linalg.norm(params[3:])
    dp = float(np.max(np.abs(params - ref)))
    if dp >= 0.05:
        raise AssertionError(f"fit params {params} vs golden {want['fit_params']}")
    dr = abs(float(res.fit.mean_reproj_error[s]) - want["mean_reproj_px"])
    if dr >= 0.01:
        raise AssertionError(f"reprojection {float(res.fit.mean_reproj_error[s])} vs {want['mean_reproj_px']}")
    out["max_dparams"] = dp
    out["d_reproj"] = dr
    out["bridged_components"] = int(res.detect1.bridged_components[s]) + int(
        res.detect2.bridged_components[s]
    )
    return out


def grid_records(det, i: int) -> list:
    """View i of a DetectResult as fixture point records."""
    return [{"id": [int(det.grid.idx[i, k, 0]), int(det.grid.idx[i, k, 1])],
             "x": float(det.grid.xy[i, k, 0]), "y": float(det.grid.xy[i, k, 1])}
            for k in range(det.grid.valid.shape[1]) if bool(det.grid.valid[i, k])]


def plane_check(det, views) -> dict:
    """The plane fixture's contract for a (V,) DetectResult: points as
    ``points_check``, ``ok`` and ``stable`` equal."""
    out = {"max_dxy": 0.0, "points": []}
    for i, want in enumerate(views):
        n, d = points_check(det.grid, i, want["points"], f"plane view {i}")
        out["max_dxy"] = max(out["max_dxy"], d)
        for flag in ("ok", "stable"):
            if bool(getattr(det, flag)[i]) != want[flag]:
                raise AssertionError(f"plane view {i}: {flag} {bool(getattr(det, flag)[i])} vs {want[flag]}")
        out["points"].append(n)
    return out


def wrapped_in(module: str) -> tuple:
    """The catalogue's kernels (``ops/kernels.CATALOGUE``) whose wrappers
    live in ``ops/<module>``, in its order."""
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    return tuple(name for name, k in kernels.CATALOGUE.items() if k.wrapper.split(".")[0] == module)


def path_kernels() -> dict:
    """``PATH_KERNELS``: the front-end kernels, the stencils, the bridge's
    routes, the XLA branch's CC and, for the knob paths, every counter of
    the catalogue."""
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    wrappers = wrapped_in("frontend") + wrapped_in("stencils")
    # The kernel branch never calls the XLA branch's CC.
    main = {"preprocess_binarize": None, "connected_components": None, "bridge_morphology": None,
            "bridge_morphology.cluster": None, **dict.fromkeys(wrapped_in("stencils"), None), "scan_cc": 0}
    every = dict(dict.fromkeys(wrappers, None), **{"bridge_morphology.split": None, "scan_cc": 0})
    out = {"endpoint": dict(main, connected_components=2, component_payload_minmax=None), "large": every,
           "variants": dict(every),
           "routes": dict(dict.fromkeys(kernels.CATALOGUE["bridge_morphology"].counters, None), scan_cc=0)}
    # The default config (the XLA branch) launches none of them, and its CC.
    out.update({path: dict(dict.fromkeys(wrappers, 0), scan_cc=None)
                for path in ("xla", "variants_xla", "cli", "corpus_xla")})
    out.update({path: dict(main) for path in ("main", "plane", "experiment", "preprocess", "stream", "mesh",
                                              "mesh_ranks", "corpus")})
    out.update({f"knobs.{name}": {k: step.get(k, 0) for k in kernels.COUNTERS} for name, step in KNOB_STEP.items()})
    return out


def reset_counts() -> None:
    """Empty the compiled steps' cache and zero every launch counter."""
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    pipeline._STREAM_STEP_CACHE.clear()
    kernels.reset_launch_counts()
    pipeline.reset_graph_launch_counts()


def card_launches() -> tuple:
    """(kernel -> launches on the card, graph replays) since
    ``reset_counts``: the wrappers' calls, less those a capture recorded
    (a capture runs no kernel), plus those each replay ran."""
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    calls, graphs = kernels.launch_counts(), pipeline.graph_launch_counts()
    return ({k: n - graphs["captured"].get(k, 0) + graphs["replayed"].get(k, 0) for k, n in calls.items()},
            graphs["replays"])


def run_path(name, fn):
    """Drive one path with the compiled steps' cache emptied and every
    launch counter reset just before and read just after (``card_launches``);
    fail if it skipped a kernel it must launch."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    res = fn()
    torch.cuda.synchronize()
    launches, replays = card_launches()
    GRAPH_REPLAYS[name] = replays
    print(f"{name} path launches: {launches} ({replays} graph replays)", flush=True)
    for k, want in PATH_KERNELS[name].items():
        if want is None and launches[k] < 1:
            raise AssertionError(f"the {name} path never launched {k}")
        if want is not None and launches[k] != want:
            raise AssertionError(f"the {name} path launched {k} {launches[k]} times, not {want}")
    return res, launches


def bridge_flips(views, cfg) -> tuple:
    """Card vs CPU through ``bridge_stage`` on the same carved masks (the
    card's): the median angles come from float32 atan2/sin/cos, whose last
    bit may differ between the two devices and move a bridge offset.
    Returns (max |d angle| in rad, differing bridged pixels)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import detector as det

    with torch.inference_mode():
        roi = det.roi_stage(det.front_stage(det._to_gray(views), cfg), cfg)
        card = det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, cfg)
        host = det.bridge_stage(roi.mh.cpu(), roi.mv.cpu(), roi.circle_radius0.cpu(), cfg)
    d_ang = float((card.angles.cpu() - host.angles).abs().max())
    flips = int((card.h_exp.cpu() != host.h_exp).sum() + (card.v_exp.cpu() != host.v_exp).sum())
    return d_ang, flips


def stage_split(views, cfgs) -> None:
    """Bridge and grid stage ms of each config on the same front and ROI
    stages (the configs differ only after them)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import detector as det

    with torch.inference_mode():
        front = det.front_stage(det._to_gray(views), cfgs[0][1])
        roi = det.roi_stage(front, cfgs[0][1])
        for label, cfg in cfgs:
            def bridge():
                return det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, cfg)

            br = bridge()
            st = det.GridState(
                cents=front.cents, inside=roi.inside, bbox=roi.bbox, h_exp=br.h_exp,
                v_exp=br.v_exp, circle_radius0=roi.circle_radius0, gray=front.gray, bright_blur=front.bright_blur,
                warm_labels=br.warm_labels, bridge_angles=br.angles, n_pre=br.n_pre,
                binary=front.binary, mh=roi.mh, mv=roi.mv, carve_domain=roi.carve_domain,
            )
            ms_b = cuda_ms(bridge, reps=10, warmup=2)
            ms_g = cuda_ms(lambda: det.grid_stage(st, cfg), reps=10, warmup=2)
            print(f"{label} stages at V={views.shape[0]}: bridge {ms_b:.4f} ms, grid {ms_g:.4f} ms",
                  flush=True)


class Capture:
    """Record the arguments of every kernel-wrapper call the detector makes
    (the wrappers are looked up on the module at call time): the front
    end's, by kernel, and the XLA branch's CC (``labeling.
    connected_components``) as ``scan_cc``."""

    def __init__(self, frontend):
        from cylinder_pose_estimation_tpu_torch.ops import labeling

        self.sites = {k: (frontend, k) for k in wrapped_in("frontend")}
        self.sites["scan_cc"] = (labeling, "connected_components")
        self.calls = {k: [] for k in self.sites}
        self.saved = {}

    def __enter__(self):
        for name, (mod, attr) in self.sites.items():
            orig = getattr(mod, attr)
            self.saved[name] = orig

            def wrapped(*args, _orig=orig, _name=name, **kwargs):
                self.calls[_name].append((args, dict(kwargs)))
                return _orig(*args, **kwargs)

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            mod, attr = self.sites[name]
            setattr(mod, attr, orig)


def line_masks(n, h, w, angles, seed, device):
    """(n, h, w) masks of broken 2-px lines at the given angles (radians)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    out = torch.zeros((n, h, w), dtype=torch.bool)
    for i in range(n):
        a = float(angles[i % len(angles)])
        ca, sa = math.cos(a), math.sin(a)
        for off in range(-w, w, 23):
            d = (xx - w / 2) * sa - (yy - h / 2) * ca - off
            along = (xx - w / 2) * ca + (yy - h / 2) * sa
            gap = (torch.rand(1, generator=g).item() * 200) - 100
            out[i] |= (d.abs() < 1.0) & ((along - gap).abs() > 4)
    ring = torch.zeros((h, w), dtype=torch.bool)
    ring[24:h - 24, 24:w - 24] = True
    return (out & ring).to(device)


def new_report() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "device_ms": 0.0, "sites": [],
            "device_launches": None, "large_sites": [], "variant_sites": [], "route_sites": [], "knob_sites": []}


def bridge_route(frontend, shape, kw):
    """(report row, most device kernels per call) of a bridge call of
    ``shape``: the plan's route picks the row; ``max_dev`` for ``compare``."""
    route = frontend.bridge_plan(*shape).get("route", "cluster")
    if route == "cluster":
        return "bridge_morphology", None
    if route == "global":
        return "bridge_morphology.global", frontend.bridge_global_launches(kw["probe_len"], kw["max_kernel"])
    return "bridge_morphology.split", DEVICE_LAUNCHES_MAX["bridge_morphology.split"]


def compare(report, name, kernel_fn, plain_fn, label, timed, nbytes=0, site=True, max_dev=None,
            into=None):
    """Hold a kernel call to its plain version (``torch.equal``) and add its
    largest error to ``report[name]``.  ``timed``: time both and count the
    kernel's device kernels per call from a CUDA graph captured from one
    call (``profiling.graph_kernels``, whose replay gives the device ms),
    which must not pass ``max_dev`` (default ``DEVICE_LAUNCHES_MAX``), and
    break a call of several kernels down by name with torch.profiler
    ("not measured" where it records none); ``site``: add the times to the
    kernel's 480x640 main-path sites, or with ``into`` to the site list of
    that name (``large_sites``, ``variant_sites``)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.utils import profiling

    out_k = kernel_fn()
    out_p = plain_fn()
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} [{label}]: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(a, b):
            n_bad = int((a != b).sum())
            raise AssertionError(f"{name} [{label}]: kernel != plain on {n_bad} elements")
    rep = report.setdefault(name, new_report())
    rep["max_abs_err"] = max(rep["max_abs_err"], err)
    line = f"kernel {name} [{label}] equal"
    if timed:
        max_dev = DEVICE_LAUNCHES_MAX[name] if max_dev is None else max_dev
        ms_k = cuda_ms(kernel_fn)
        ms_p = cuda_ms(plain_fn, reps=5, warmup=1)
        n_dev, dev_ms = profiling.graph_kernels(kernel_fn)
        if n_dev > max_dev:
            raise AssertionError(f"{name} [{label}]: {n_dev} device kernels in a call (at most {max_dev})")
        by_name = profiler_kernels(kernel_fn)[1] if n_dev > 1 else None
        if site and into is not None:
            rep[into].append({"site": label, "ms": ms_k, "device_ms": dev_ms, "plain_ms": ms_p,
                              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                              "device_kernels_per_call": n_dev, "device_ms_by_kernel": by_name})
        elif site:
            rep["device_ms"] += dev_ms
            rep["ms"] += ms_k
            rep["plain_ms"] += ms_p
            rep["bytes"] += nbytes
            rep["sites"].append((label, ms_k, ms_p, nbytes, n_dev))
            rep["device_launches"] = max(rep["device_launches"] or 0, n_dev)
        line += (f"; kernel {ms_k:.4f} ms (graph replay {dev_ms:.4f} device ms), plain {ms_p:.4f} ms, bound "
                 f"{bound_ms(nbytes):.4f} ms ({nbytes} B), device kernels per call {n_dev}")
        if n_dev > 1:
            by_txt = "not measured" if by_name is None else {k: round(v, 4) for k, v in by_name.items()}
            line += f", profiler device ms by kernel {by_txt}"
    print(line, flush=True)


@contextlib.contextmanager
def solve_spd_as(fn):
    """Every caller of ``ops/linalg.solve_spd`` (the LM, the polyfit, the
    normal equations) calls ``fn`` in its place."""
    from cylinder_pose_estimation_tpu_torch.ops import linalg, lm, polyfit

    mods = (linalg, lm, polyfit)
    saved = [m.solve_spd for m in mods]
    for m in mods:
        m.solve_spd = fn
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.solve_spd = f


def solve_phase(report, fn) -> None:
    """The kernels line's ``solve_spd`` row: the kernel against
    ``solve_spd_plain`` on the card, held and timed as phase 6 holds the
    others, on the first solve of each shape that ``fn()`` makes (a B=16
    main-path call: the LM's (16, 6, 6), the curvature's (16, 5, 5), the
    grid stage's polyfit (32, 48, 3, 3)).  Those hold NaN and infinite
    solutions (empty rows), so the two are compared as bit patterns.  Bytes:
    a, b and x once."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops import linalg

    solve, sites = linalg.solve_spd, {}

    def bits(x):
        return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)

    def record(a, b):
        sites.setdefault(tuple(a.shape), (a.clone(), b.clone()))
        return solve(a, b)

    with solve_spd_as(record):
        fn()
    for shape, (a, b) in sites.items():
        compare(report, "solve_spd", lambda: bits(linalg.solve_spd(a, b)), lambda: bits(linalg.solve_spd_plain(a, b)),
                f"captured {shape} {a.dtype}", timed=True, nbytes=(a.numel() + 2 * b.numel()) * a.element_size())


def kernel_phase(frontend, calls, device, seed: int = 0) -> dict:
    """Every kernel vs its plain version on the captured production
    intermediates plus seeded random inputs; returns per-kernel reports."""
    import functools

    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import _smooth
    from cylinder_pose_estimation_tpu_torch.ops import kernels

    g = torch.Generator(device="cpu").manual_seed(seed)
    report = {}
    compare_ = functools.partial(compare, report)

    # 2.1 preprocess: the B=16 run's smoothed views + smoothed noise images.
    for i, (args, kw) in enumerate(calls["preprocess_binarize"]):
        x = args[0]
        compare_("preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                lambda: frontend.preprocess_binarize_plain(x, **kw),
                f"captured {tuple(x.shape)}", timed=(i == 0),
                nbytes=kernels.min_bytes("preprocess_binarize", *x.shape))
        noise = torch.rand(x.shape, generator=g).mul(255.0).to(device)
        xs = _smooth(noise, CylinderDetectConfig())
        compare_("preprocess_binarize", lambda: frontend.preprocess_binarize(xs, **kw),
                lambda: frontend.preprocess_binarize_plain(xs, **kw),
                f"random {tuple(xs.shape)}", timed=False)

    # 2.2 connected components: the three call sites + random masks.
    for args, kw in calls["connected_components"]:
        m = args[0]
        init = kw.get("init_labels")
        label = (f"captured {tuple(m.shape)} {kw['rounds']}x{kw['pools_per_round']} "
                 f"{'warm' if init is not None else 'cold'}")
        compare_("connected_components",
                lambda: frontend.connected_components(m, kw["rounds"], kw["pools_per_round"], init),
                lambda: frontend.connected_components_plain(m, kw["rounds"], kw["pools_per_round"], init),
                label, timed=True,
                nbytes=kernels.min_bytes("connected_components", *m.shape, warm=init is not None))
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rinit = None
        if init is not None:
            rinit = torch.randint(0, 2 * m.shape[1] * m.shape[2], m.shape, generator=g,
                                  dtype=torch.int32).to(device)
        compare_("connected_components",
                lambda: frontend.connected_components(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                lambda: frontend.connected_components_plain(rnd, kw["rounds"], kw["pools_per_round"], rinit),
                f"random {tuple(m.shape)}", timed=False)

    # 2.4 payload min/max: the endpoint path's call + random masks with
    # random payloads (a permutation of [0, H*W) per image).
    for args, kw in calls["component_payload_minmax"]:
        m, pay = args
        rounds, pools = kw["rounds"], kw["pools_per_round"]
        compare_("component_payload_minmax",
                lambda: frontend.component_payload_minmax(m, pay, rounds, pools),
                lambda: frontend.component_payload_minmax_plain(m, pay, rounds, pools),
                f"captured {tuple(m.shape)} {rounds}x{pools}", timed=True,
                nbytes=kernels.min_bytes("component_payload_minmax", *m.shape))
        n, h, w = m.shape
        rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
        rpay = torch.stack([torch.randperm(h * w, generator=g) for _ in range(n)])
        rpay = rpay.reshape(n, h, w).to(torch.int32).to(device)
        for r, p in ((rounds, pools), (1, 2), (3, 1)):
            compare_("component_payload_minmax",
                    lambda: frontend.component_payload_minmax(rnd, rpay, r, p),
                    lambda: frontend.component_payload_minmax_plain(rnd, rpay, r, p),
                    f"random {tuple(m.shape)} {r}x{p}", timed=False)

    # 2.3 bridge: the captured call (bool, the detector's interface), the
    # same as float32, line masks at non-axis angles with kernel lengths from
    # 0 past the cap (both types), and the kernel's own schedule against
    # bridge_schedule on the card.
    for args, kw in calls["bridge_morphology"]:
        masks, exps, angles, klen = args
        compare_("bridge_morphology",
                lambda: frontend.bridge_morphology(masks, exps, angles, klen, **kw),
                lambda: frontend.bridge_morphology_plain(masks, exps, angles, klen, **kw),
                f"captured {tuple(masks.shape)} {masks.dtype}", timed=True,
                nbytes=kernels.min_bytes("bridge_morphology", *masks.shape, itemsize=masks.element_size()))
        mf, ef = masks.to(torch.float32), exps.to(torch.float32)
        compare_("bridge_morphology",
                lambda: frontend.bridge_morphology(mf, ef, angles, klen, **kw),
                lambda: frontend.bridge_morphology_plain(mf, ef, angles, klen, **kw),
                f"captured {tuple(mf.shape)} {mf.dtype}", timed=True, site=False,
                nbytes=kernels.min_bytes("bridge_morphology", *mf.shape))
        n, h, w = masks.shape
        ang_list = [0.0, math.pi / 2, 0.35, 1.2, -0.6, 2.5]
        lm = line_masks(n, h, w, ang_list, seed + 1, device)
        ex = (torch.rand(lm.shape, generator=g) < 0.7).to(device)
        ang = torch.tensor([ang_list[i % len(ang_list)] for i in range(n)], dtype=torch.float32,
                           device=device)
        kl = torch.linspace(0.0, 260.0, n, device=device)
        for dtype in (torch.bool, torch.float32):
            lmt, ext = lm.to(dtype), ex.to(dtype)
            compare_("bridge_morphology",
                    lambda: frontend.bridge_morphology(lmt, ext, ang, kl, **kw),
                    lambda: frontend.bridge_morphology_plain(lmt, ext, ang, kl, **kw),
                    f"line masks {tuple(lm.shape)} {dtype}", timed=False)
        schedule_check(frontend, device, g, **kw)
    return report


def schedule_check(frontend, device, g, probe_len, max_kernel) -> None:
    """The bridge kernel's in-kernel schedule (sinf, cosf, rintf) must equal
    ``bridge_schedule`` by torch on the card for SCHEDULE_ANGLES angles and
    a kernel length per mask pair; prints how many masks' schedules differ
    from the CPU's."""
    import torch

    n = SCHEDULE_ANGLES
    ang = (torch.rand(n, generator=g) * 2 - 1) * math.pi
    kl = torch.rand(n // 2, generator=g) * 320.0
    m = torch.zeros((n, 2, 32), dtype=torch.bool, device=device)
    sched = torch.zeros((n, frontend.bridge_schedule_size(probe_len, max_kernel)), dtype=torch.int32,
                        device=device)
    frontend.bridge_morphology(m, m, ang.to(device), kl.to(device), probe_len, max_kernel, schedule_out=sched)

    def flat(ang, kl):
        ray, line = frontend.bridge_schedule(ang, kl, probe_len, max_kernel)
        return torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1)

    card = flat(ang.to(device), kl.to(device))
    bad = int((sched != card).any(1).sum())
    if bad:
        raise AssertionError(f"bridge schedule: {bad} of {n} masks differ from bridge_schedule on the card")
    host = int((sched.cpu() != flat(ang, kl)).any(1).sum())
    print(f"kernel bridge_morphology schedule equal to bridge_schedule on the card for {n} angles; "
          f"{host} of them differ from the CPU's schedule", flush=True)


def load_registration_fixture(device):
    """The registration fixture's inputs as tensors on ``device``:
    (fixture dict, pts3s (F, C, 3), valid (F, C), angles (F, 2),
    frame_valid (F,))."""
    import numpy as np
    import torch

    with open(REGISTRATION) as f:
        fx = json.load(f)
    n, cap = len(fx["n_valid"]), fx["capacity"]
    pts = np.zeros((n, cap, 3), np.float32)
    valid = np.zeros((n, cap), bool)
    for i, (k, flat) in enumerate(zip(fx["n_valid"], fx["pts"])):
        pts[i, :k] = np.asarray(flat, np.float32).reshape(k, 3)
        valid[i, :k] = True
    angles = np.asarray(fx["angles"], np.float32)
    frame_valid = np.asarray(fx["frame_valid"], bool)
    return fx, *(torch.as_tensor(x, device=device) for x in (pts, valid, angles, frame_valid))


def registration_check(got, want: dict, angles, label: str) -> dict:
    """A RegistrationResult against a reference (a dict of floats and the
    4x4 t_cam_agv): predicted axes within 0.05 deg and 0.1 mm perpendicular
    offset, fval (atol 1e-6) and jtj_min_eig within rel 1e-2, well_posed
    equal."""
    import numpy as np

    from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors

    t = got.t_cam_agv.detach().cpu().numpy()
    if not np.all(np.isfinite(t)):
        raise AssertionError(f"{label}: non-finite T_Cam_AGV")
    ang, perp = axis_errors(want["t_cam_agv"], t, angles)
    out = {"axis_deg": float(ang.max()), "perp_mm": float(perp.max())}
    for name in ("fval0", "fval", "jtj_min_eig"):
        out[name] = float(getattr(got, name))
        out[f"{name}_rel"] = abs(out[name] - want[name]) / max(abs(want[name]), 1e-12)
    out["well_posed"] = bool(got.well_posed)
    if out["axis_deg"] >= 0.05 or out["perp_mm"] >= 0.1:
        raise AssertionError(f"{label}: axes {out['axis_deg']} deg, perpendicular {out['perp_mm']} mm")
    if abs(out["fval"] - want["fval"]) > 1e-6 + 1e-2 * abs(want["fval"]):
        raise AssertionError(f"{label}: fval {out['fval']} vs {want['fval']}")
    if out["jtj_min_eig_rel"] > 1e-2:
        raise AssertionError(f"{label}: jtj_min_eig {out['jtj_min_eig']} vs {want['jtj_min_eig']}")
    if out["well_posed"] != want["well_posed"]:
        raise AssertionError(f"{label}: well_posed {out['well_posed']} vs {want['well_posed']}")
    return out


def reg_dict(res) -> dict:
    return {"t_cam_agv": res.t_cam_agv.detach().cpu().numpy(), "fval0": float(res.fval0),
            "fval": float(res.fval), "jtj_min_eig": float(res.jtj_min_eig),
            "well_posed": bool(res.well_posed)}


def sync_sites(fn) -> dict:
    """Run fn() once under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the host synchronisations by the source line that caused them
    (PyTorch's "called a synchronizing CUDA operation" warnings; the mode's
    own one-time notice that it is a prototype is not one)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def registration_phase(device, stereo_fn, cfg, fit_cfg, smi):
    """Phase 8: the registration fixture on the card, then the experiment
    path with its CPU recomputation.  Returns (the launches, the experiment's
    inputs and unsharded result for phase 16)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.geometry.registration import (
        axis_errors,
        fit_cylinders_with_angles,
    )
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_sequence

    fx, pts, valid, angles, frame_valid = load_registration_fixture(device)
    res = fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid)
    sites = sync_sites(lambda: fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid))
    print(f"registration host syncs per call: {sum(sites.values())} at {sites}", flush=True)
    if sites:
        raise AssertionError(f"the registration synchronises with the host: {sites}")
    chk = registration_check(res, fx["result"], fx["angles"], "registration fixture")
    ms_fix = cuda_ms(lambda: fit_cylinders_with_angles(pts, valid, angles, frame_valid=frame_valid),
                     reps=3, warmup=1)
    print(f"registration fixture ({pts.shape[0]} frames x {pts.shape[1]}), card vs JAX: axes "
          f"{chk['axis_deg']:.3e} deg, perp {chk['perp_mm']:.3e} mm, fval {chk['fval']:.6g} "
          f"(rel {chk['fval_rel']:.2e}), fval0 rel {chk['fval0_rel']:.2e}, min_eig "
          f"{chk['jtj_min_eig']:.6g} (rel {chk['jtj_min_eig_rel']:.2e}), well_posed "
          f"{chk['well_posed']}; {ms_fix:.2f} ms; {smi}", flush=True)

    n_frames = EXPERIMENT_FRAMES
    st_np, ang_np, (i1, i2), t_gt = registration_sequence(n_frames, 480, 640)
    stereo = stereo_fn(st_np)
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    ang = torch.as_tensor(ang_np, device=device)
    (batch, reg), launches = run_path(
        "experiment", lambda: pipeline.full_experiment(a, b, ang, stereo, cfg, fit_cfg))
    if not all(bool(torch.isfinite(x).all()) for x in (reg.t_cam_agv, reg.fval, reg.fval0)):
        raise AssertionError("experiment: non-finite registration")
    healthy = int(pipeline.frame_health(batch).sum())
    gt_ang, gt_perp = axis_errors(t_gt, reg.t_cam_agv.cpu().numpy(), ang_np)
    print(f"experiment F={n_frames} 480x640: healthy {healthy}/{n_frames}, ok "
          f"{int((batch.detect1.ok & batch.detect2.ok).sum())}, points3 {tuple(batch.fit.points3.shape)}, "
          f"fval0 {float(reg.fval0):.6g}, fval {float(reg.fval):.6g}, min_eig "
          f"{float(reg.jtj_min_eig):.6g}, well_posed {bool(reg.well_posed)}; vs ground truth: axes "
          f"{gt_ang.max():.4f} deg, perp {gt_perp.max():.4f} mm", flush=True)
    t0 = time.perf_counter()
    host = pipeline.register_sequence(pipeline._tree_map(lambda x: x.cpu(), batch), ang.cpu())
    t_cpu = time.perf_counter() - t0
    card = reg_dict(reg)
    print(f"experiment registration recomputed on the CPU ({t_cpu:.1f} s): fval {float(host.fval):.6g}, "
          f"min_eig {float(host.jtj_min_eig):.6g}, well_posed {bool(host.well_posed)} (card: "
          f"{card['jtj_min_eig']:.6g}, {card['well_posed']})", flush=True)
    chk = registration_check(host, card, ang_np, "experiment registration, CPU vs card")
    print(f"experiment registration, CPU vs card: axes {chk['axis_deg']:.3e} deg, perp "
          f"{chk['perp_mm']:.3e} mm, fval rel {chk['fval_rel']:.2e}, min_eig rel "
          f"{chk['jtj_min_eig_rel']:.2e}", flush=True)

    return launches, {"frames": (i1, i2, ang_np), "stereo": stereo, "batch": batch, "reg": reg}


def preprocess_phase(device, stereo_fn, cfg, fit_cfg, smi) -> dict:
    """Phase 9: the preprocessing path at B=16 and its card-vs-CPU checks."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        distorted_example_pair,
        registration_angles,
    )

    n = PREPROCESS_BATCH
    st_np, (i1, i2) = distorted_example_pair(480, 640, n_frames=n)
    stereo = stereo_fn(st_np)
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    ang = torch.as_tensor(registration_angles(n), device=device)
    (batch, reg), launches = run_path(
        "preprocess", lambda: pipeline.full_experiment(a, b, ang, stereo, cfg, fit_cfg, preprocess=True))
    if not bool(torch.isfinite(reg.t_cam_agv).all()):
        raise AssertionError("preprocess path: non-finite registration")
    ok = int((batch.detect1.ok & batch.detect2.ok).sum())
    host_stereo = pipeline._stereo_to(stereo, torch.device("cpu"))
    card = pipeline.preprocess_stereo_batch(a, b, stereo)
    host = pipeline.preprocess_stereo_batch(a.cpu(), b.cpu(), host_stereo)
    d_max, n_over = 0.0, 0
    for c, h in zip(card, host):
        d = (c.cpu() - h).abs()
        d_max = max(d_max, float(d.max()))
        n_over += int((d > 1e-3).sum())
    print(f"preprocess B={n} 480x640, card vs CPU: max |d| {d_max:.3e} grey levels, {n_over} pixels "
          f"over 1e-3; ok frames {ok}/{n}", flush=True)
    if d_max > 1e-2:
        raise AssertionError(f"preprocess card vs CPU: {d_max} grey levels")
    det_card = pipeline.estimate_poses_batch(card[0][:2], card[1][:2], stereo, cfg, fit_cfg)
    det_host = pipeline.estimate_poses_batch(host[0][:2], host[1][:2], host_stereo, cfg, fit_cfg)
    max_d = 0.0
    for dc, dh in ((det_card.detect1, det_host.detect1), (det_card.detect2, det_host.detect2)):
        for i in range(2):
            _, d = points_check(dc.grid, i, grid_records(dh, i), f"preprocessed frame {i}")
            max_d = max(max_d, d)
    print(f"preprocessed detect, 2 frames card vs CPU: ids identical, max |dxy| {max_d:.6f} px",
          flush=True)
    ms = cuda_ms(lambda: pipeline.preprocess_stereo_batch(a, b, stereo), reps=10, warmup=2)
    print(f"preprocess_stereo_batch B={n} 480x640: {ms / n:.4f} ms/frame; {smi}", flush=True)
    return launches


def stream_phase(device, stereo, cfg, fit_cfg, smi) -> dict:
    """Phase 10: the stream path over 2,000 frames and its chunk-by-chunk
    equality with the batch call."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import TiledFrames, example_pair

    n, chunk, pool = STREAM_FRAMES, STREAM_CHUNK, STREAM_POOL
    _, (p1, p2) = example_pair(480, 640, n_frames=pool, pans=[i % 13 for i in range(pool)])
    f1 = TiledFrames(np.clip(p1, 0, 255).astype(np.uint8), n)
    f2 = TiledFrames(np.clip(p2, 0, 255).astype(np.uint8), n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    out, launches = run_path("stream", lambda: pipeline.estimate_poses_stream(
        f1, f2, stereo, cfg, fit_cfg, chunk=chunk, compact=True, overlap=True, device=device))
    peak = torch.cuda.max_memory_allocated(device)
    # The same stream without the overlap: one chunk at a time.
    serial = pipeline.estimate_poses_stream(f1, f2, stereo, cfg, fit_cfg, chunk=chunk, compact=True,
                                            overlap=False, device=device)
    got = pipeline._tree_leaves(out)
    for s in range(0, n, chunk):
        live = min(chunk, n - s)
        idx = np.minimum(np.arange(s, s + chunk), n - 1)
        a = torch.as_tensor(np.stack([f1[i:i + 1][0] for i in idx]), device=device)
        b = torch.as_tensor(np.stack([f2[i:i + 1][0] for i in idx]), device=device)
        want = pipeline._tree_leaves(pipeline._summarize_batch(
            pipeline.estimate_poses_batch(a, b, stereo, cfg, fit_cfg), RegistrationConfig()))
        for leaf, (g, w) in enumerate(zip(got, want)):
            w = w[:live].cpu().numpy()
            if not np.array_equal(g[s:s + live], w, equal_nan=np.issubdtype(w.dtype, np.floating)):
                raise AssertionError(f"stream chunk at {s}: leaf {leaf} differs from the batch call")
    for leaf, (g, w) in enumerate(zip(got, pipeline._tree_leaves(serial))):
        if not np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating)):
            raise AssertionError(f"stream: leaf {leaf} differs between overlap and serial")
    ok = int(out.ok.sum())
    reproj = float(np.median(out.mean_reproj_error[out.ok]))
    print(f"stream N={n} chunk={chunk} compact overlap: ok {ok}/{n}, healthy {int(out.healthy.sum())}, median "
          f"reprojection {reproj:.4f} px, peak device memory {peak / 2**20:.1f} MiB; every chunk equal to the "
          f"batch call ({(n + chunk - 1) // chunk} chunks, tail {n % chunk or chunk} live), the serial run "
          f"(overlap=False) equal to the overlapped one; {smi}", flush=True)
    return launches


def xla_phase(a, b, stereo, pviews, golden, plane_views, fit_cfg) -> dict:
    """Phase 11: the default configuration (the XLA branch) on the phase-2
    scenes and the phase-4 views, against the XLA records; none of the
    front end's kernels or stencils may launch, and its CC (``scan_cc``)
    must."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch

    h, w = a.shape[-2:]
    cfg = CylinderDetectConfig(height=h, width=w)
    cfg_plane = PlaneDetectConfig(height=h, width=w, roi_threshold=30.0)
    if cfg.use_pallas or cfg_plane.use_pallas:
        raise AssertionError("the default configuration must be the XLA branch")
    (res, det), launches = run_path("xla", lambda: (
        estimate_poses_batch(a, b, stereo, cfg, fit_cfg), detect_grid(pviews, cfg_plane)))
    for s, name in enumerate(list(range(6)) + ["gap0"]):
        want = next(g for g in golden if g["scene"] == name)
        chk = golden_check(res, want, s, gauge=True)
        if chk["bridged_components"] != want.get("bridged_components", 0):
            raise AssertionError(f"xla scene {name} bridged {chk['bridged_components']}")
        print(f"xla scene {name}: points {chk['n_view1']}/{chk['n_view2']}, max|dxy| {chk['max_dxy']:.6f} px, "
              f"max|dparams| {chk['max_dparams']:.6f} (raw {chk['max_dparams_raw']:.6f}), "
              f"|dreproj| {chk['d_reproj']:.6f} px, bridged_components {chk['bridged_components']}", flush=True)
    chk = plane_check(det, [dict(v, stable=v["stable_xla"]) for v in plane_views])
    print(f"xla plane views: points {chk['points']}, max|dxy| {chk['max_dxy']:.6f} px, stable "
          f"{det.stable.tolist()} (the XLA record)", flush=True)
    return launches


def hold_sites(report, frontend, calls, tag, timed, into="large_sites") -> None:
    """Hold every kernel-wrapper call ``Capture`` recorded to its plain
    version on the same inputs (``compare``: ``torch.equal``); with
    ``timed`` also time each call and add it, with its byte bound, to the
    kernel's ``into`` site list (None: its 480x640 sites; the XLA branch's
    CC only).  A bridge call is held as recorded (bool) and as float32; only
    the recorded call is timed."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops import kernels, labeling

    with torch.inference_mode():
        for args, kw in calls["preprocess_binarize"]:
            x = args[0]
            compare(report, "preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                    lambda: frontend.preprocess_binarize_plain(x, **kw), f"{tag} {tuple(x.shape)}", timed,
                    nbytes=kernels.min_bytes("preprocess_binarize", *x.shape), into="large_sites")
        for args, kw in calls["connected_components"]:
            m, init = args[0], kw.get("init_labels")
            r, p = kw["rounds"], kw["pools_per_round"]
            plan = frontend.cc_plan(*m.shape, pools_per_round=p)
            glob = plan.get("route") == "global"
            compare(report, "connected_components",
                    lambda: frontend.connected_components(m, r, p, init),
                    lambda: frontend.connected_components_plain(m, r, p, init),
                    f"{tag} {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'}"
                    f"{' global' if glob else ''}", timed,
                    nbytes=kernels.min_bytes("connected_components", *m.shape, warm=init is not None),
                    max_dev=frontend.cc_global_launches(r, p, plan["fused"]) if glob else None,
                    into="large_sites")
        for args, kw in calls["component_payload_minmax"]:
            m, pay = args
            r, p = kw["rounds"], kw["pools_per_round"]
            plan = frontend.cc_plan(*m.shape, channels=2, pools_per_round=p)
            glob = plan.get("route") == "global"
            compare(report, "component_payload_minmax",
                    lambda: frontend.component_payload_minmax(m, pay, r, p),
                    lambda: frontend.component_payload_minmax_plain(m, pay, r, p),
                    f"{tag} {tuple(m.shape)} {r}x{p}{' global' if glob else ''}", True,
                    nbytes=kernels.min_bytes("component_payload_minmax", *m.shape),
                    max_dev=frontend.cc_global_launches(r, p, plan["fused"]) if glob else None,
                    into="large_sites")
        for args, kw in calls["bridge_morphology"]:
            masks, exps, angles, klen = args
            row, max_dev = bridge_route(frontend, masks.shape, kw)
            for mk, ek, site in ((masks, exps, True), (masks.float(), exps.float(), False)):
                compare(report, row,
                        lambda: frontend.bridge_morphology(mk, ek, angles, klen, **kw),
                        lambda: frontend.bridge_morphology_plain(mk, ek, angles, klen, **kw),
                        f"{tag} {tuple(mk.shape)} {mk.dtype} {row}", timed and site,
                        nbytes=kernels.min_bytes("bridge_morphology", *mk.shape, itemsize=mk.element_size()),
                        max_dev=max_dev, into="large_sites")
        for args, kw in calls.get("scan_cc", ()):
            m, iters = args[0], (args[1:] or [kw.get("iters", 16)])[0]
            compare(report, "scan_cc", lambda: labeling.connected_components(m, iters),
                    lambda: labeling.connected_components_plain(m, iters), f"{tag} {tuple(m.shape)} {iters} rounds",
                    timed, nbytes=kernels.min_bytes("scan_cc", *m.shape), max_dev=labeling.scan_cc_launches(iters),
                    into=into)


def large_phase(frontend, device, fit_cfg, smi):
    """Phase 12: the main and endpoint configs at LARGE_SIZES; returns (the
    launches, a kernel report whose ``large_sites`` hold the timed calls)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    def cfg_of(h, w, label):
        return CylinderDetectConfig(height=h, width=w, use_pallas=True,
                                    bridge_endpoint_stats=label == "endpoint")

    inputs = {hw: example_pair(*hw, n_frames=LARGE_BATCH) for hw in LARGE_SIZES}
    calls = {}

    def drive():
        out = {}
        for (h, w), (st_np, (i1, i2)) in inputs.items():
            stereo = stereo_from_numpy(*st_np, device=device)
            a = torch.as_tensor(i1, device=device)
            b = torch.as_tensor(i2, device=device)
            for label in ("main", "endpoint"):
                with Capture(frontend) as cap:
                    out[(h, w, label)] = estimate_poses_batch(a, b, stereo, cfg_of(h, w, label), fit_cfg)
                calls[(h, w, label)] = cap.calls
        return out

    out, launches = run_path("large", drive)
    for (h, w, label), res in out.items():
        st_np, (i1, i2) = inputs[(h, w)]
        t0 = time.perf_counter()
        host = estimate_poses_batch(torch.as_tensor(i1), torch.as_tensor(i2),
                                    stereo_from_numpy(*st_np, device="cpu"), cfg_of(h, w, label), fit_cfg)
        t_cpu = time.perf_counter() - t0
        max_d, pts = 0.0, []
        for dc, dh in ((res.detect1, host.detect1), (res.detect2, host.detect2)):
            for i in range(LARGE_BATCH):
                n, d = points_check(dc.grid, i, grid_records(dh, i), f"{h}x{w} {label} frame {i}")
                pts.append(n)
                max_d = max(max_d, d)
                for flag in ("ok", "stable"):
                    if bool(getattr(dc, flag)[i]) != bool(getattr(dh, flag)[i]):
                        raise AssertionError(f"{h}x{w} {label} frame {i}: {flag} differs card vs CPU")
        print(f"large {h}x{w} {label}, card vs CPU ({t_cpu:.1f} s on the CPU): ids identical, points {pts}, "
              f"max |dxy| {max_d:.6f} px, ok {res.detect1.ok.tolist()}/{res.detect2.ok.tolist()}, stable "
              f"{res.detect1.stable.tolist()}/{res.detect2.stable.tolist()}", flush=True)

    report = {}
    for (h, w, label), cap in calls.items():
        hold_sites(report, frontend, cap, f"{h}x{w} {label}", label == "main")

    rep = itertools.count(1)
    for (h, w), (st_np, (i1, i2)) in inputs.items():
        stereo = stereo_from_numpy(*st_np, device=device)
        a = torch.as_tensor(i1, device=device)
        b = torch.as_tensor(i2, device=device)
        for label in ("main", "endpoint"):
            cfg = cfg_of(h, w, label)

            def e2e():
                eps = 1e-4 * next(rep)
                return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg).fit.params

            def detect():
                eps = 1e-4 * next(rep)
                return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

            ms_e2e = cuda_ms(e2e, reps=5, warmup=1)
            ms_det = cuda_ms(detect, reps=5, warmup=1)
            print(f"large {label} B={LARGE_BATCH} {h}x{w}: {ms_e2e / LARGE_BATCH:.4f} ms/frame (detect "
                  f"{ms_det / LARGE_BATCH:.4f} ms/frame); {smi}", flush=True)
    return launches, report


def variants_phase(frontend, device, fit_cfg, smi):
    """Phase 13: the full-resolution variants and sub-pixel refinement at
    480x640 (``torch_variant_scenes.json``'s configurations: B=16 frames of
    ``example_pair``, or the plane fixture's eight views), the kernel-branch
    and the XLA-branch configurations each as a path, counters reset just
    before and read just after.  Every view is held to the JAX record (ids
    identical, xy within 0.05 px); the first VARIANT_CPU_FRAMES frames are
    held card against the CPU port (ids, xy within 0.05 px, ``ok`` and
    ``stable``); every kernel call at a full-resolution shape, and every
    call of the XLA branch's CC (``scan_cc``), is held ``torch.equal`` to
    its plain version, the first of each site timed.  Returns (launches by
    path, kernel report with ``variant_sites``)."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _tree_map, estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import kernels, labeling
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair, plane_view

    h, w = 480, 640
    with open(VARIANTS) as f:
        configs = json.load(f)["records"][f"{h}x{w}"]["configs"]
    with open(PLANE) as f:
        pspecs = [v["spec"] for v in json.load(f)["views"]]
    st_np, (i1, i2) = example_pair(h, w, n_frames=VARIANT_FRAMES)
    stereo = stereo_from_numpy(*st_np, device=device)
    host_stereo = stereo_from_numpy(*st_np, device="cpu")
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)
    planes = np.stack([plane_view(h, w, **sp) for sp in pspecs])
    pviews = torch.as_tensor(planes, device=device)

    def cfg_of(c):
        cls = PlaneDetectConfig if c["mode"] == "plane" else CylinderDetectConfig
        return cls(height=h, width=w, use_pallas=c["use_pallas"], **c["overrides"])

    def run(c, imgs=None):
        """The configuration's entry point: detect_grid on the plane views,
        estimate_poses_batch on the frames; returns the (V,) DetectResult."""
        cfg = cfg_of(c)
        if c["mode"] == "plane":
            return detect_grid(pviews if imgs is None else imgs, cfg)
        x, y, st = (a, b, stereo) if imgs is None else imgs
        res = estimate_poses_batch(x, y, st, cfg, fit_cfg)
        if not bool(torch.isfinite(res.fit.params).all()):
            raise AssertionError(f"variant {c['name']}: non-finite fit")
        return _tree_map(lambda p, q: torch.cat([p, q]), res.detect1, res.detect2)

    calls, results = {}, {}

    def drive(group):
        for c in group:
            with Capture(frontend) as cap:
                results[c["name"]] = run(c)
            calls[c["name"]] = cap.calls
        return results

    kern = [c for c in configs if c["use_pallas"]]
    xla = [c for c in configs if not c["use_pallas"]]
    _, launches = run_path("variants", lambda: drive(kern))
    _, launches_xla = run_path("variants_xla", lambda: drive(xla))

    for c in configs:
        det = results[c["name"]]
        max_d, n_ok, n_stable, n_bridged = 0.0, 0, 0, 0
        for i, want in enumerate(c["views"]):
            _, d = points_check(det.grid, i, want["points"], f"variant {c['name']} view {i}")
            max_d = max(max_d, d)
            n_ok += bool(det.ok[i]) == want["ok"]
            n_stable += bool(det.stable[i]) == want["stable"]
            n_bridged += int(det.bridged_components[i]) == want["bridged_components"]
        n = len(c["views"])
        # Card vs CPU on the first frames (both views of each).
        k = VARIANT_CPU_FRAMES
        t0 = time.perf_counter()
        if c["mode"] == "plane":
            host = run(c, torch.as_tensor(planes[:k]))
            pairs = [(i, i) for i in range(k)]
        else:
            host = run(c, (torch.as_tensor(i1[:k]), torch.as_tensor(i2[:k]), host_stereo))
            pairs = [(i, i) for i in range(k)] + [(VARIANT_FRAMES + i, k + i) for i in range(k)]
        t_cpu = time.perf_counter() - t0
        max_dc = 0.0
        for ic, ih in pairs:
            _, d = points_check(det.grid, ic, grid_records(host, ih), f"variant {c['name']} view {ic} vs CPU")
            max_dc = max(max_dc, d)
            for flag in ("ok", "stable"):
                if bool(getattr(det, flag)[ic]) != bool(getattr(host, flag)[ih]):
                    raise AssertionError(f"variant {c['name']} view {ic}: {flag} differs card vs CPU")
        print(f"variant {c['name']} ({c['mode']}, {n} views): ids identical to the JAX record, max |dxy| "
              f"{max_d:.6f} px; ok {n_ok}/{n}, stable {n_stable}/{n}, bridged {n_bridged}/{n} as recorded; "
              f"card vs CPU ({len(pairs)} views, {t_cpu:.1f} s on the CPU): ids identical, max |dxy| "
              f"{max_dc:.6f} px", flush=True)

    # Kernel calls at full-resolution shapes (the new sites) against plain.
    report, timed_sites = {}, set()
    with torch.inference_mode():
        for name, cap in calls.items():
            for kname in ("connected_components", "component_payload_minmax", "bridge_morphology"):
                for args, kw in cap[kname]:
                    m = args[0]
                    if tuple(m.shape[-2:]) != (h, w):
                        continue
                    row = kname
                    if kname == "bridge_morphology":
                        masks, exps, angles, klen = args
                        key = (kname, tuple(masks.shape), kw["probe_len"], kw["max_kernel"])
                        row, max_dev = bridge_route(frontend, masks.shape, kw)
                        label = (f"{name} {tuple(masks.shape)} probe {kw['probe_len']} max_kernel "
                                 f"{kw['max_kernel']} {row}")
                        kfn = functools.partial(frontend.bridge_morphology, masks, exps, angles, klen, **kw)
                        pfn = functools.partial(frontend.bridge_morphology_plain, masks, exps, angles, klen,
                                                **kw)
                        nbytes = kernels.min_bytes(kname, *masks.shape, itemsize=masks.element_size())
                    else:
                        r, p = kw["rounds"], kw["pools_per_round"]
                        if kname == "connected_components":
                            init = kw.get("init_labels")
                            key = (kname, tuple(m.shape), r, p, init is not None)
                            plan = frontend.cc_plan(*m.shape, pools_per_round=p)
                            label = f"{name} {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'}"
                            kfn = functools.partial(frontend.connected_components, m, r, p, init)
                            pfn = functools.partial(frontend.connected_components_plain, m, r, p, init)
                            nbytes = kernels.min_bytes(kname, *m.shape, warm=init is not None)
                        else:
                            pay = args[1]
                            key = (kname, tuple(m.shape), r, p)
                            plan = frontend.cc_plan(*m.shape, channels=2, pools_per_round=p)
                            label = f"{name} {tuple(m.shape)} {r}x{p}"
                            kfn = functools.partial(frontend.component_payload_minmax, m, pay, r, p)
                            pfn = functools.partial(frontend.component_payload_minmax_plain, m, pay, r, p)
                            nbytes = kernels.min_bytes(kname, *m.shape)
                        glob = plan.get("route") == "global"
                        max_dev = frontend.cc_global_launches(r, p, plan["fused"]) if glob else None
                        label += " global" if glob else ""
                    timed = key not in timed_sites
                    timed_sites.add(key)
                    compare(report, row, kfn, pfn, label, timed, nbytes=nbytes, max_dev=max_dev,
                            into="variant_sites")
            # The XLA branch's CC at every canvas of the XLA variants, each
            # (shape, rounds) timed once.
            for args, kw in cap["scan_cc"]:
                m, iters = args[0], (args[1:] or [kw.get("iters", 16)])[0]
                key = ("scan_cc", tuple(m.shape), iters)
                timed = key not in timed_sites
                timed_sites.add(key)
                compare(report, "scan_cc", functools.partial(labeling.connected_components, m, iters),
                        functools.partial(labeling.connected_components_plain, m, iters),
                        f"{name} {tuple(m.shape)} {iters} rounds", timed, nbytes=kernels.min_bytes("scan_cc", *m.shape),
                        max_dev=labeling.scan_cc_launches(iters), into="variant_sites")

    rep = itertools.count(1)
    for c in configs:
        cfg = cfg_of(c)
        if c["mode"] == "plane":
            ms = cuda_ms(lambda: detect_grid(pviews + 1e-4 * next(rep), cfg).grid.xy, reps=5, warmup=1)
            print(f"variant {c['name']} V={len(pspecs)} {h}x{w}: detect {ms / len(pspecs):.4f} ms/view; {smi}",
                  flush=True)
            continue

        def e2e():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg).fit.params

        def detect():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

        ms_e2e = cuda_ms(e2e, reps=5, warmup=1)
        ms_det = cuda_ms(detect, reps=5, warmup=1)
        print(f"variant {c['name']} B={VARIANT_FRAMES} {h}x{w}: {ms_e2e / VARIANT_FRAMES:.4f} ms/frame "
              f"(detect {ms_det / VARIANT_FRAMES:.4f} ms/frame); {smi}", flush=True)
    return {"variants": launches, "variants_xla": launches_xla}, report


def routes_phase(frontend, device):
    """Phase 15: ``bridge_morphology`` at ROUTE_SHAPES, one call per route
    of ``bridge_plan``, counters reset just before and read just after; then
    each call held to plain (``torch.equal``) and timed, its schedule to
    ``bridge_schedule``.  Returns (the launches, a report whose
    ``route_sites`` hold the calls)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops import kernels

    kw = {"probe_len": 9, "max_kernel": 251}
    angs = torch.tensor([math.pi / 2, 1.45, 0.35, -0.6, 2.5, 0.0], device=device)
    inputs = {}
    for row, (n, h, w) in ROUTE_SHAPES.items():
        # Broken 2-px lines every 23 px at near-vertical and other angles,
        # pixels on every border, made on the card.
        a = angs[torch.arange(n, device=device) % len(angs)][:, None, None]
        yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None] - h / 2
        xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :] - w / 2
        d = xx * torch.sin(a) - yy * torch.cos(a)
        along = xx * torch.cos(a) + yy * torch.sin(a)
        m = ((torch.remainder(d, 23.0) - 11.5).abs() < 1.0) & ((torch.remainder(along, 41.0) - 20.5).abs() > 4)
        m[:, 0, ::3] = True
        m[:, -1, 1::4] = True
        m[:, ::5, 0] = True
        m[:, 2::3, -1] = True
        ex = torch.remainder(xx * 7 + yy * 13, 10.0).expand(n, h, w) < 8
        inputs[row] = (m, ex, angs[torch.arange(n, device=device) % len(angs)],
                       torch.linspace(20.0, 300.0, n, device=device))

    def drive():
        return {row: frontend.bridge_morphology(*args, **kw) for row, args in inputs.items()}

    _, launches = run_path("routes", drive)
    report = {}
    with torch.inference_mode():
        for want, (m, ex, ang, kl) in inputs.items():
            n = m.shape[0]
            row, max_dev = bridge_route(frontend, m.shape, kw)
            if (row if row != "bridge_morphology" else "bridge_morphology.cluster") != want:
                raise AssertionError(f"bridge {tuple(m.shape)}: plan route {row}, not {want}")
            sched = torch.zeros((n, frontend.bridge_schedule_size(**kw)), dtype=torch.int32, device=device)
            compare(report, row, lambda: frontend.bridge_morphology(m, ex, ang, kl, schedule_out=sched, **kw),
                    lambda: frontend.bridge_morphology_plain(m, ex, ang, kl, **kw),
                    f"routes {tuple(m.shape)} {m.dtype} probe 9 max_kernel 251 {want}", True,
                    nbytes=kernels.min_bytes("bridge_morphology", *m.shape, itemsize=1), max_dev=max_dev,
                    into="route_sites")
            ray, line = frontend.bridge_schedule(ang, kl, **kw)
            if not torch.equal(sched, torch.cat([ray.reshape(n, -1), line.reshape(n, -1)], 1)):
                raise AssertionError(f"bridge {want} {tuple(m.shape)}: schedule differs from bridge_schedule")
            print(f"bridge {want} {tuple(m.shape)}: schedule equal to bridge_schedule", flush=True)
    return launches, report


_FLOAT = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def parse_experiment(text: str) -> dict:
    """The printed output of ``cylpose-torch experiment``: per-frame
    errors, the registration's fvals, healthy frames, observability and
    T_Cam_AGV."""
    import re

    import numpy as np

    frames = re.findall(rf"average error = ({_FLOAT}) -> ({_FLOAT}) mm", text)
    fval0, fval = re.search(rf"registration fval: ({_FLOAT}) -> ({_FLOAT})", text).groups()
    obs = re.search(rf"registration: (\d+) of \d+ frames healthy, min eigenvalue ({_FLOAT}), "
                    r"well posed (True|False)", text)
    t = [float(v) for v in re.findall(_FLOAT, text.split("T_Cam_AGV =")[1])[:16]]
    return {"frames": [(float(x), float(y)) for x, y in frames], "fval0": float(fval0), "fval": float(fval),
            "healthy": int(obs.group(1)), "jtj_min_eig": float(obs.group(2)),
            "well_posed": obs.group(3) == "True", "t_cam_agv": np.asarray(t).reshape(4, 4)}


def cli_phase(smi) -> dict:
    """Phase 14: the ``cylpose-torch`` drivers on the card
    (``cli.main([..., "--device", "cuda"])``) over PNG frames of
    ``write_registration_folder`` in a temporary directory, counters reset
    just before and read just after (the drivers' default config launches
    none of the four kernels); ``detect-folder`` and ``experiment`` held to
    ``torch_cli.json`` (the JAX CLI on the same files: ids identical, xy
    within 0.05 px, no image in error; T_Cam_AGV within 0.05 deg and 0.1 mm,
    fval rel 1e-2, healthy frames and well_posed equal), ``undistort-folder``
    within one grey level of the port on the CPU."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from cylinder_pose_estimation_tpu_torch import cli
    from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors
    from cylinder_pose_estimation_tpu_torch.utils import png
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import write_registration_folder

    h, w = 480, 640
    with open(CLI_RECORD) as f:
        rec = json.load(f)["records"][f"{h}x{w}"]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        if write_registration_folder(src, rec["frames"], h, w) != rec["names"]:
            raise AssertionError("the CLI frames' names differ from the record")
        cam = os.path.join(src, "cameras.json")
        wall = {}

        def run(cmd, *argv, device="cuda"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main([cmd, "--camera-json", cam, "--input", src, *argv, "--device", device])
            wall[f"{cmd} {device}"] = time.perf_counter() - t0
            return buf.getvalue()

        def drive():
            return {
                "detect": run("detect-folder", "--output", os.path.join(tmp, "detect")),
                "experiment": run("experiment", *rec["experiment_args"]),
                "undistort": run("undistort-folder", "--output", os.path.join(tmp, "und")),
            }

        out, launches = run_path("cli", drive)
        with open(os.path.join(tmp, "detect", "processed_images_data.json")) as f:
            data = json.load(f)
        errors = {k: v["error"] for k, v in data.items() if "error" in v}
        if errors:
            raise AssertionError(f"detect-folder recorded errors: {errors}")
        if set(data) != set(rec["detect_folder"]):
            raise AssertionError(f"detect-folder files {sorted(data)} vs {sorted(rec['detect_folder'])}")
        max_d, n_pts = 0.0, 0
        for name, want in rec["detect_folder"].items():
            got = {p["id"]: (p["x"], p["y"]) for p in data[name]["points"]}
            ref = {p["id"]: (p["x"], p["y"]) for p in want["points"]}
            if set(got) != set(ref):
                raise AssertionError(f"detect-folder {name}: ids {sorted(got)} vs {sorted(ref)}")
            for k, (x, y) in ref.items():
                max_d = max(max_d, abs(got[k][0] - x), abs(got[k][1] - y))
            n_pts += len(ref)
            if not os.path.exists(os.path.join(tmp, "detect", os.path.splitext(name)[0] + "_arc.png")):
                raise AssertionError(f"detect-folder wrote no overlay for {name}")
        if max_d >= 0.05:
            raise AssertionError(f"detect-folder: max |dxy| {max_d} px against the JAX CLI")
        print(f"cli detect-folder ({len(data)} images, {wall['detect-folder cuda']:.1f} s): ids identical to "
              f"the JAX CLI, {n_pts} points, max |dxy| {max_d:.6f} px", flush=True)

        got = parse_experiment(out["experiment"])
        want = rec["experiment"]
        ang, perp = axis_errors(np.asarray(want["t_cam_agv"]), got["t_cam_agv"],
                                np.radians(np.asarray(rec["angles_deg"], np.float64)))
        fval_rel = abs(got["fval"] - want["fval"]) / abs(want["fval"])
        if ang.max() >= 0.05 or perp.max() >= 0.1 or fval_rel > 1e-2:
            raise AssertionError(f"experiment: axes {ang.max()} deg, perp {perp.max()} mm, fval rel {fval_rel}")
        if (got["healthy"], got["well_posed"]) != (want["healthy"], want["well_posed"]):
            raise AssertionError(f"experiment: healthy {got['healthy']}, well_posed {got['well_posed']} vs "
                                 f"{want['healthy']}, {want['well_posed']}")
        print(f"cli experiment {' '.join(rec['experiment_args'])} ({rec['frames']} frames, "
              f"{wall['experiment cuda']:.1f} s): vs the JAX CLI axes {ang.max():.3e} deg, perp {perp.max():.3e} "
              f"mm, fval {got['fval']:.6g} (rel {fval_rel:.2e}), healthy {got['healthy']}, min_eig "
              f"{got['jtj_min_eig']:.6g}, well_posed {got['well_posed']}", flush=True)

        run("undistort-folder", "--output", os.path.join(tmp, "und_cpu"), device="cpu")
        names = sorted(os.listdir(os.path.join(tmp, "und_cpu")))
        if sorted(os.listdir(os.path.join(tmp, "und"))) != names or len(names) != 2 * rec["frames"]:
            raise AssertionError("undistort-folder wrote other files on the card than on the CPU")
        max_g, n_diff = 0, 0
        for name in names:
            card = png.read_png(os.path.join(tmp, "und", name)).astype(np.int64)
            host = png.read_png(os.path.join(tmp, "und_cpu", name)).astype(np.int64)
            max_g = max(max_g, int(np.abs(card - host).max()))
            n_diff += int((card != host).sum())
        if max_g > 1:
            raise AssertionError(f"undistort-folder card vs CPU: {max_g} grey levels")
        print(f"cli undistort-folder ({len(names)} images, {wall['undistort-folder cuda']:.1f} s): card vs CPU "
              f"max {max_g} grey level, {n_diff} pixels differ; {smi}", flush=True)
    return launches


def hold_calls(frontend, calls, label) -> dict:
    """Hold every captured call of the main path's kernels, and of the XLA
    branch's CC, to its plain version on the same inputs (``torch.equal``,
    untimed); the number of calls held per kernel."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops import labeling

    report = {}
    with torch.inference_mode():
        for args, kw in calls["preprocess_binarize"]:
            x = args[0]
            compare(report, "preprocess_binarize", lambda: frontend.preprocess_binarize(x, **kw),
                    lambda: frontend.preprocess_binarize_plain(x, **kw), f"{label} {tuple(x.shape)}", False)
        for args, kw in calls["connected_components"]:
            m, init = args[0], kw.get("init_labels")
            r, p = kw["rounds"], kw["pools_per_round"]
            compare(report, "connected_components", lambda: frontend.connected_components(m, r, p, init),
                    lambda: frontend.connected_components_plain(m, r, p, init),
                    f"{label} {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'}", False)
        for args, kw in calls["bridge_morphology"]:
            masks, exps, angles, klen = args
            row, _ = bridge_route(frontend, masks.shape, kw)
            compare(report, row, lambda: frontend.bridge_morphology(masks, exps, angles, klen, **kw),
                    lambda: frontend.bridge_morphology_plain(masks, exps, angles, klen, **kw),
                    f"{label} {tuple(masks.shape)} {row}", False)
        for args, kw in calls["scan_cc"]:
            m, iters = args[0], (args[1:] or [kw.get("iters", 16)])[0]
            compare(report, "scan_cc", lambda: labeling.connected_components(m, iters),
                    lambda: labeling.connected_components_plain(m, iters),
                    f"{label} {tuple(m.shape)} {iters} rounds", False)
    if calls["component_payload_minmax"]:
        raise AssertionError(f"{label}: the main path called component_payload_minmax")
    return {k: len(v) for k, v in calls.items()}


def corpus_hold(card, host, i: int, chaotic: bool, label: str) -> dict:
    """View i of the card's DetectResult against the CPU port's: ``ok`` and
    ``stable`` equal; outside the chaotic window also ids identical and xy
    within 0.05 px.  Returns the points, the largest move and the id-set
    difference."""
    for flag in ("ok", "stable"):
        if bool(getattr(card, flag)[i]) != bool(getattr(host, flag)[i]):
            raise AssertionError(f"{label}: {flag} {bool(getattr(card, flag)[i])} on the card, "
                                 f"{bool(getattr(host, flag)[i])} on the CPU")
    g, h = grid_map(card.grid, i), grid_map(host.grid, i)
    diff = len(set(g) ^ set(h))
    if chaotic:
        return {"points": len(h), "max_dxy": None, "id_diff": diff}
    if diff:
        raise AssertionError(f"{label}: id sets differ, card +{sorted(set(g) - set(h))} -{sorted(set(h) - set(g))}")
    d = max((float(abs(g[k] - h[k]).max()) for k in h), default=0.0)
    if d >= 0.05:
        raise AssertionError(f"{label}: a point moves {d} px between the card and the CPU")
    return {"points": len(h), "max_dxy": d, "id_diff": 0}


def oracle_check(views, cfg, names) -> list:
    """The card's post-bridge state of each view (``front_stage``,
    ``roi_stage``, ``bridge_stage``) replayed through the numpy oracle of
    the reference's bookkeeping (tests/_oracle_detect.py); the card's final
    grid must match it id for id, every coordinate and the centre within
    0.05 px.  Returns (points, largest move) per view."""
    import importlib.util

    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.models import detector as det

    spec = importlib.util.spec_from_file_location("_oracle_detect", ORACLE)
    od = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(od)
    h, w = views.shape[-2:]
    with torch.inference_mode():
        gray = det._to_gray(views)
        front = det.front_stage(gray, cfg)
        roi = det.roi_stage(front, cfg)
        br = det.bridge_stage(roi.mh, roi.mv, roi.circle_radius0, cfg)
        res = det.detect_grid(views, cfg)
    out = []
    for i, name in enumerate(names):
        inside = roi.inside[i].cpu().numpy()
        js, _ = od.detect_bookkeeping(
            det._upsample2(br.h_exp[i], h, w).cpu().numpy(), det._upsample2(br.v_exp[i], h, w).cpu().numpy(),
            front.cents[i].cpu().numpy()[inside], roi.bbox[i].cpu().numpy(), front.gray[i].cpu().numpy(),
            float(roi.circle_radius0[i]), degree=cfg.poly_degree, prune=cfg.drop_first_row or cfg.drop_last_col)
        if js is None:
            raise AssertionError(f"oracle {name}: the oracle found no grid")
        data = json.loads(js)
        oracle = {tuple(p["id"]): np.asarray((p["x"], p["y"])) for p in data["points"]}
        card = grid_map(res.grid, i)
        if set(card) != set(oracle):
            raise AssertionError(f"oracle {name}: id sets differ, card +{sorted(set(card) - set(oracle))} "
                                 f"-{sorted(set(oracle) - set(card))}")
        d = max(float(abs(card[k] - oracle[k]).max()) for k in card)
        dc = float(abs(res.grid.center[i].cpu().numpy() - np.asarray(data["center_point"])).max())
        if d >= 0.05 or dc >= 0.05:
            raise AssertionError(f"oracle {name}: points {d} px, centre {dc} px from the oracle")
        out.append((len(card), max(d, dc)))
    return out


def corpus_phase(frontend, device, golden_views, smi) -> dict:
    """Phase 17: the JAX package's detection corpora on the card.  Inputs:
    the stability fence's lattices (``CORPUS_LATTICES``, rendered by
    ``utils.synthetic.tilted_grid_view``) and the frames of
    ``tests/fixtures/torch_corpus_scenes.npz`` (the gap scenes, one view of
    the independent family at each size, the k1=-1.2 distortion pair and its
    control).  Each branch runs every input through its entry points:
    ``detect_grid`` on the views, ``undistort_image`` then
    ``estimate_poses_batch`` on the distortion frames; the kernel branch as
    the path "corpus" (counters reset just before and read just after, every
    kernel call held ``torch.equal`` to its plain version), the XLA branch
    as "corpus_xla".  Both are held to the CPU port on the same inputs by
    ``corpus_hold`` (the distortion frames' fitted axes within 1e-3 rad).
    Then the numpy oracle on the card's post-bridge state of golden scenes
    0 and gap0_pallas (``golden_views``).  Prints each scene and the ms per
    view; returns the launches by path."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import tilted_grid_view

    fx = np.load(CORPUS)
    small = [(f"lattice {a:g} deg seed {s}", tilted_grid_view(240, 320, a, s), a in CORPUS_CHAOTIC)
             for a, s in CORPUS_LATTICES]
    small += [(k, fx[k], False) for k in CORPUS_SMALL]
    groups = [((240, 320), small), ((480, 640), [(k, fx[k], False) for k in CORPUS_LARGE])]
    dist = [np.stack([fx[f"dist_distorted_{v}"], fx[f"dist_control_{v}"]]) for v in (1, 2)]
    st_np = [fx[f"dist_stereo_{i}"] for i in range(7)]
    fit_cfg = FitConfig(cyl_radius=float(fx["dist_radius"]))

    def run(dev, use_pallas):
        with torch.inference_mode():
            dets = []
            for (h, w), views in groups:
                x = torch.as_tensor(np.stack([v for _, v, _ in views]), device=dev)
                dets.append(detect_grid(x, CylinderDetectConfig(height=h, width=w, use_pallas=use_pallas)))
            st = stereo_from_numpy(*st_np, device=dev)
            a, b = (torch.as_tensor(x, device=dev) for x in dist)
            a = torch.cat([undistort_image(a[:1], st.cam1), a[1:]])
            b = torch.cat([undistort_image(b[:1], st.cam2), b[1:]])
            pose = estimate_poses_batch(a, b, st, CylinderDetectConfig(height=240, width=320, use_pallas=use_pallas),
                                        fit_cfg)
        return dets, pose

    with Capture(frontend) as cap:
        card_k, launches = run_path("corpus", lambda: run(device, True))
    held = hold_calls(frontend, cap.calls, "corpus")
    print(f"corpus: kernel calls held torch.equal to their plain versions: {held}", flush=True)
    with Capture(frontend) as cap:
        card_x, launches_x = run_path("corpus_xla", lambda: run(device, False))
    held = hold_calls(frontend, cap.calls, "corpus_xla")
    print(f"corpus_xla: XLA CC calls held torch.equal to the plain version: {held['scan_cc']}", flush=True)

    chaotic_diff = {}
    for branch, (dets, pose), (hdets, hpose) in (("kernels", card_k, run("cpu", True)),
                                                  ("xla", card_x, run("cpu", False))):
        for g, (_, views) in enumerate(groups):
            for i, (name, _, chaotic) in enumerate(views):
                r = corpus_hold(dets[g], hdets[g], i, chaotic, f"corpus {branch} {name}")
                flags = {f: bool(getattr(dets[g], f)[i]) for f in ("ok", "stable", "labels_converged")}
                d_tilt = abs(float(dets[g].max_line_tilt[i]) - float(hdets[g].max_line_tilt[i]))
                if chaotic:
                    chaotic_diff[f"{branch} {name}"] = r["id_diff"]
                    moved = f"chaotic window, id sets differ by {r['id_diff']}"
                else:
                    moved = f"ids identical, max|dxy| {r['max_dxy']:.6f} px"
                print(f"corpus {branch} {name}: {r['points']} points, {moved}, {flags} equal card vs CPU, "
                      f"|d max_line_tilt| {d_tilt:.3e} rad", flush=True)
        for f, tag in enumerate(("k1=-1.2 undistorted", "k1=-1.2 control")):
            for view in ("detect1", "detect2"):
                r = corpus_hold(getattr(pose, view), getattr(hpose, view), f, False,
                                f"corpus {branch} {tag} {view}")
            axes = [p.fit.params[f, 3:6].cpu().double() for p in (pose, hpose)]
            cos = abs(float(torch.dot(axes[0], axes[1]) / (axes[0].norm() * axes[1].norm())))
            ang = math.acos(min(1.0, cos))
            if ang >= 1e-3:
                raise AssertionError(f"corpus {branch} {tag}: fitted axes {ang} rad apart, card vs CPU")
            print(f"corpus {branch} {tag}: both views ids identical card vs CPU (last view max|dxy| "
                  f"{r['max_dxy']:.6f} px), axis {ang:.3e} rad from the CPU's, reprojection "
                  f"{float(pose.fit.mean_reproj_error[f]):.4f} px", flush=True)
    print(f"corpus: ok and stable equal card vs CPU on every view of both branches; chaotic-window id-set "
          f"differences {chaotic_diff}", flush=True)

    for use_pallas, label in ((True, "kernels"), (False, "xla")):
        (h, w), views = groups[0]
        x = torch.as_tensor(np.stack([v for _, v, _ in views]), device=device)
        c = CylinderDetectConfig(height=h, width=w, use_pallas=use_pallas)
        with torch.inference_mode():
            ms = cuda_ms(lambda: detect_grid(x, c).grid.xy, reps=5, warmup=1)
        print(f"corpus {label} detect V={len(views)} {h}x{w}: {ms / len(views):.4f} ms/view; {smi}", flush=True)

    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True)
    for name, (n, d) in zip(("0", "gap0_pallas"), oracle_check(golden_views, cfg, ("0", "gap0_pallas"))):
        print(f"corpus oracle golden scene {name}: {n} points match the numpy oracle on the card's post-bridge "
              f"state, max |d| {d:.6f} px", flush=True)
    return {"corpus": launches, "corpus_xla": launches_x}


def knobs_phase(frontend, device, fit_cfg, smi):
    """Phase 18: the knob configurations of ``torch_knob_scenes.json``'s
    480x640 record through ``estimate_poses_batch`` on B=KNOB_FRAMES frames
    of ``example_pair``, each as the path "knobs.<name>" (counters reset
    just before and read just after; one step's launches as ``KNOB_STEP``
    says).  Every view is held to the JAX record (ids identical, xy within
    0.05 px); ``ok``, ``stable`` and the bridged counts are counted against
    it, and the first KNOB_CPU_FRAMES frames against the CPU port (ids, xy
    within 0.05 px; ``ok``/``stable`` flips counted).  Then the kernels'
    new branches against their plain versions (``torch.equal``), each site
    timed: the in-kernel smoothing on the smoothing path's (32, 480, 640)
    call and on grey frames at (4, 720, 1280); the capped scans on the
    cross-cap paths' calls, (32, 240, 384) and (32, 480, 640), both on the
    band route, and on random masks at the same shapes.  Prints
    e2e and detect ms/frame of each configuration.  Returns (launches by
    path, a report whose ``knob_sites`` hold the timed calls)."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models.pipeline import _tree_map, estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import kernels
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    h, w = 480, 640
    with open(KNOBS) as f:
        configs = json.load(f)["records"][f"{h}x{w}"]["configs"]
    if sorted(c["name"] for c in configs) != sorted(KNOB_STEP):
        raise AssertionError(f"the knob record's configurations are not KNOB_STEP's: {[c['name'] for c in configs]}")
    st_np, (i1, i2) = example_pair(h, w, n_frames=KNOB_FRAMES)
    stereo = stereo_from_numpy(*st_np, device=device)
    host_stereo = stereo_from_numpy(*st_np, device="cpu")
    a = torch.as_tensor(i1, device=device)
    b = torch.as_tensor(i2, device=device)

    def cfg_of(c):
        return CylinderDetectConfig(height=h, width=w, use_pallas=c["use_pallas"], **c["overrides"])

    def run(c, x, y, st):
        """The configuration's step: both views of every frame as one (2F,)
        DetectResult."""
        res = estimate_poses_batch(x, y, st, cfg_of(c), fit_cfg)
        if not bool(torch.isfinite(res.fit.params).all()):
            raise AssertionError(f"knob {c['name']}: non-finite fit")
        return _tree_map(lambda p, q: torch.cat([p, q]), res.detect1, res.detect2)

    launches, calls = {}, {}
    k = KNOB_CPU_FRAMES
    for c in configs:
        name = c["name"]
        with Capture(frontend) as cap:
            det, launches[f"knobs.{name}"] = run_path(f"knobs.{name}", lambda: run(c, a, b, stereo))
        calls[name] = cap.calls
        max_d, n_ok, n_stable, n_bridged = 0.0, 0, 0, 0
        for i, want in enumerate(c["views"]):
            _, d = points_check(det.grid, i, want["points"], f"knob {name} view {i}")
            max_d = max(max_d, d)
            n_ok += bool(det.ok[i]) == want["ok"]
            n_stable += bool(det.stable[i]) == want["stable"]
            n_bridged += int(det.bridged_components[i]) == want["bridged_components"]
        n = len(c["views"])
        t0 = time.perf_counter()
        with torch.inference_mode():
            host = run(c, torch.as_tensor(i1[:k]), torch.as_tensor(i2[:k]), host_stereo)
        t_cpu = time.perf_counter() - t0
        max_dc, flips = 0.0, 0
        for ic, ih in [(i, i) for i in range(k)] + [(KNOB_FRAMES + i, k + i) for i in range(k)]:
            _, d = points_check(det.grid, ic, grid_records(host, ih), f"knob {name} view {ic} vs CPU")
            max_dc = max(max_dc, d)
            flips += sum(bool(getattr(det, f)[ic]) != bool(getattr(host, f)[ih]) for f in ("ok", "stable"))
        print(f"knob {name}: {n} views, ids identical to the JAX record, max |dxy| {max_d:.6f} px; ok {n_ok}/{n}, "
              f"stable {n_stable}/{n}, bridged {n_bridged}/{n} as recorded; card vs CPU ({2 * k} views, "
              f"{t_cpu:.1f} s on the CPU): ids identical, max |dxy| {max_dc:.6f} px, {flips} ok/stable flips",
              flush=True)

    report = {}
    with torch.inference_mode():
        # 2.1's smoothing: the smoothing path's call and grey frames at 720x1280.
        _, (g1, g2) = example_pair(720, 1280, n_frames=2)
        grey = torch.as_tensor(np.concatenate([g1, g2]), device=device)
        sites = [(args[0], kw) for args, kw in calls["smoothing_kernel"]["preprocess_binarize"]]
        sites.append((grey, dict(sites[0][1])))
        for x, kw in sites:
            if kw.get("pre_smoothed", False):
                raise AssertionError("the smoothing path called the preprocess kernel on a smoothed image")
            compare(report, "preprocess_binarize.smoothing",
                    functools.partial(frontend.preprocess_binarize, x, **kw),
                    functools.partial(frontend.preprocess_binarize_plain, x, **kw),
                    f"knobs {tuple(x.shape)} pre_smoothed=False", True,
                    nbytes=kernels.min_bytes("preprocess_binarize", *x.shape),
                    max_dev=DEVICE_LAUNCHES_MAX["preprocess_binarize"], into="knob_sites")
            # The smoothing launch alone: its plane against the four rolls.
            taps = {k: kw[k] for k in ("blur_ksize", "ridge_sigma") if k in kw}
            compare(report, "preprocess_binarize.smoothing",
                    functools.partial(frontend.wrapped_smoothing, x, **taps),
                    functools.partial(frontend.wrapped_smoothing_plain, x, **taps),
                    f"knobs {tuple(x.shape)} the smoothing launch alone", False)
        n_dev = [site["device_kernels_per_call"] for site in report["preprocess_binarize.smoothing"]["knob_sites"]]
        if any(d != SMOOTHING_DEVICE_KERNELS for d in n_dev):
            raise AssertionError(f"the smoothing's preprocess calls launched {n_dev} device kernels, not "
                                 f"{SMOOTHING_DEVICE_KERNELS} each")
        # 2.2's capped scans: the cross-cap paths' capped calls, then random
        # masks at the same shapes (untimed).
        g = torch.Generator(device="cpu").manual_seed(18)
        row = "connected_components.capped.band"
        for name in ("cross_cap_kernel", "cross_cap_ds1_kernel"):
            capped = [(args[0], kw) for args, kw in calls[name]["connected_components"] if kw.get("cap", 0) > 0]
            if len(capped) != 2 or {kw["cap_axis"] for _, kw in capped} != {0, 1}:
                raise AssertionError(f"knob {name}: capped calls {[kw.get('cap_axis') for _, kw in capped]}")
            for m, kw in capped:
                r, p, init = kw["rounds"], kw["pools_per_round"], kw.get("init_labels")
                cap_kw = {"cap_axis": kw["cap_axis"], "cap": kw["cap"]}
                plan = frontend.cc_plan(*m.shape, pools_per_round=p, **cap_kw)
                if plan.get("route") != "global":
                    raise AssertionError(f"knob {name} {tuple(m.shape)}: plan {plan} is not the band route")
                label = (f"knobs {tuple(m.shape)} {r}x{p} {'warm' if init is not None else 'cold'} cap_axis "
                         f"{kw['cap_axis']} cap {kw['cap']}")
                compare(report, row, functools.partial(frontend.connected_components, m, r, p, init, **cap_kw),
                        functools.partial(frontend.connected_components_plain, m, r, p, init, **cap_kw), label, True,
                        nbytes=kernels.min_bytes("connected_components", *m.shape, warm=init is not None),
                        max_dev=frontend.cc_global_launches(r, p, plan["fused"]), into="knob_sites")
                rnd = (torch.rand(m.shape, generator=g) < 0.45).to(torch.float32).to(device)
                rinit = torch.randint(0, 2 * m.shape[1] * m.shape[2], m.shape, generator=g,
                                      dtype=torch.int32).to(device)
                for rr, pp, start in ((r, p, None), (r, p, rinit), (1, 2, None), (3, 1, rinit)):
                    compare(report, row,
                            functools.partial(frontend.connected_components, rnd, rr, pp, start, **cap_kw),
                            functools.partial(frontend.connected_components_plain, rnd, rr, pp, start, **cap_kw),
                            f"knobs random {tuple(m.shape)} {rr}x{pp} cap_axis {kw['cap_axis']}", False)

    rep = itertools.count(1)
    for c in configs:
        cfg = cfg_of(c)

        def e2e():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg).fit.params

        def detect():
            eps = 1e-4 * next(rep)
            return estimate_poses_batch(a + eps, b + eps, stereo, cfg, fit_cfg, probe="detect").grid.xy

        ms_e2e = cuda_ms(e2e, reps=5, warmup=1)
        ms_det = cuda_ms(detect, reps=5, warmup=1)
        print(f"knob {c['name']} B={KNOB_FRAMES} {h}x{w}: {ms_e2e / KNOB_FRAMES:.4f} ms/frame "
              f"(detect {ms_det / KNOB_FRAMES:.4f} ms/frame); {smi}", flush=True)
    return launches, report


def corr64(x, taps, dim):
    """Zero-padded correlation out[i] = sum_t taps[t] * x[i + t - r] along
    ``dim``, in float64."""
    import torch

    x = x.double()
    r = len(taps) // 2
    n = x.shape[dim]
    out = torch.zeros_like(x)
    for t, v in enumerate(taps):
        sh = t - r
        if abs(sh) < n:
            out.narrow(dim, max(0, -sh), n - abs(sh)).add_(x.narrow(dim, max(0, sh), n - abs(sh)), alpha=float(v))
    return out


def bf16_pass_bound(inter, taps):
    """What the second pass of a bf16-operand band pair (``taps`` as the
    band holds them) may differ by between two summation orders, in
    float64: the pass's own 2 gamma_n, plus one bfloat16 step (2^-7
    relative) of every intermediate whose last bits the first pass may
    have rounded the other way."""
    k = [abs(v) for v in taps]
    g = len(taps) * 2.0**-24 * 1.01
    return 2 * g * corr64(inter.bfloat16().to(inter.dtype).abs(), k, 1) + corr64(inter.abs() * 2.0**-7, k, 1)


def bf16_taps(taps):
    """Taps as a default-mode band matrix holds them: float32, then bfloat16."""
    import torch

    return torch.tensor(taps, dtype=torch.float32).bfloat16().float().tolist()


def two_pass_bound(x, taps):
    """What two float32 summation orders of the same two passes of ``taps``
    (float32 operands and intermediate) may differ by: 2 gamma_n of the
    terms' magnitudes in each pass, the first's carried through the second."""
    k = [abs(v) for v in taps]
    return 4 * 1.01 * len(taps) * 2.0**-24 * corr64(corr64(x.abs(), k, 2), k, 1)


@contextlib.contextmanager
def matmul_route(stencils):
    """The front stage's former route: the stencil wrappers replaced by their
    plain versions, the banded matmuls (the detector looks them up on the
    module at call time)."""
    saved = stencils.smooth, stencils.stats_images
    stencils.smooth, stencils.stats_images = stencils.smooth_plain, stencils.stats_images_plain
    try:
        yield
    finally:
        stencils.smooth, stencils.stats_images = saved


def hold_stats(cell, gray, args, sargs, got, want, sat) -> dict:
    """Phase 20's hold of the statistic-image stencil (``got``, with the
    saturation blur ``sat`` before its threshold) against the banded
    matmuls (``want``) on the same inputs; raises where they part.  The
    centroid images torch.equal (sums of integers); the saturation blur and
    the index blur within their bf16 pair's bound of the matmuls' (the
    operands are bf16, only the summation order differs); the saturation
    mask equal but where the matmuls' blur lies within that bound of the
    threshold (a tie of the two orders); the centre box within two float32
    passes' bound over its area.  Returns the differing pixels and the
    largest differences."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops import mxu_conv as mxc

    h, w = gray.shape[-2:]
    dev = gray.device
    if not (torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])):
        raise AssertionError(f"stencil_stats at {cell}: the centroid images differ")
    gt = mxc.gauss_taps_cv(sargs["sat_blur_ksize"])
    inter = mxc.conv_x(gray, mxc.x_mat(gt, w, dev))
    sat_plain = mxc.conv_y(inter, mxc.y_mat(gt, h, dev))
    bound = bf16_pass_bound(inter, bf16_taps(gt))
    d_sat = (sat.double() - sat_plain.double()).abs()
    if not bool((d_sat <= bound).all()):
        raise AssertionError(f"stencil_stats at {cell}: {int((d_sat > bound).sum())} saturation-blur pixels "
                             f"past the bound")
    flips = got[0] != want[0]
    ties = (sat_plain.double() - sargs["sat_threshold"]).abs() <= bound
    if not bool((flips <= ties).all()):
        raise AssertionError(f"stencil_stats at {cell}: {int((flips & ~ties).sum())} saturation-mask pixels "
                             f"differ away from a tie")
    gk = mxc.gauss_taps_cv(sargs["index_blur_ksize"])
    inter = mxc.conv_x(gray, mxc.x_mat(gk, w, dev))
    d_blur = (got[2].double() - want[2].double()).abs()
    if not bool((d_blur <= bf16_pass_bound(inter, bf16_taps(gk))).all()):
        raise AssertionError(f"stencil_stats at {cell}: bright_blur past its bound")
    row = {"sat_max_abs_diff": float(d_sat.max()), "sat_mask_differ": int(flips.sum()),
           "sat_mask_ties": int(ties.sum()), "bright_blur_differ": int((d_blur > 0).sum()),
           "bright_blur_max_abs_diff": float(d_blur.max()), "bright_center_max_abs_diff": None}
    if sargs["center_patch_half"] is not None:
        pc = 2 * sargs["center_patch_half"] + 1
        d_c = (got[1].double() - want[1].double()).abs()
        cb = two_pass_bound(gray, [1.0] * pc) / pc**2 + want[1].double().abs() * 2.0**-23
        if not bool((d_c <= cb).all()):
            raise AssertionError(f"stencil_stats at {cell}: bright_center past its bound")
        row["bright_center_max_abs_diff"] = float(d_c.max())
    elif got[1] is not None or want[1] is not None:
        raise AssertionError(f"stencil_stats at {cell}: a centre image without a centre box")
    return row


def stencil_phase(device, smi) -> dict:
    """Phase 20: the front stage's stencils held, timed and counted against
    the banded matmuls they replace (see the module docstring).  Returns
    the sites' rows (each stencil's timing under its name) and the routes'
    differing counts."""
    import numpy as np
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu_torch.models import detector
    from cylinder_pose_estimation_tpu_torch.ops import frontend, kernels, stencils
    from cylinder_pose_estimation_tpu_torch.utils import profiling
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    pools = {}
    for hw in sorted({site[2] for site in STENCIL_SITES}):
        _, (p1, p2) = example_pair(*hw, n_frames=STENCIL_POOL, pans=[float(i % 13) for i in range(STENCIL_POOL)])
        pools[hw] = torch.as_tensor(np.concatenate([p1, p2]), device=device)
    out = {"card": smi, "sites": [], "routes": []}
    for cell, n, hw, knobs in STENCIL_SITES:
        cfg = CylinderDetectConfig(height=hw[0], width=hw[1], use_pallas=True, **knobs)
        pool = pools[hw]
        gray = pool[torch.arange(n, device=device) % pool.shape[0]].contiguous()
        gray += torch.arange(n, device=device, dtype=torch.float32)[:, None, None] % 5  # distinct views
        kw = dict(blur_ksize=cfg.blur_ksize, ridge_sigma=cfg.ridge_sigma)
        smoothed = stencils.smooth(gray, **kw)
        former = stencils.smooth_plain(gray, **kw)
        bound = two_pass_bound(gray, stencils.smooth_taps(**kw))
        diff = (smoothed.double() - former.double()).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"stencil_smooth at {cell}: {int((diff > bound).sum())} pixels past the bound")
        pre = frontend.preprocess_binarize(former, margin=detector._border_margin(cfg),
                                           joint_peak_iters=cfg.joint_peak_iters, pre_smoothed=True)
        args = (gray, pre[3], pre[4])
        sargs = detector._stats_args(cfg)
        sat = torch.empty_like(gray)
        got = stencils.stats_images(*args, sat_out=sat, **sargs)
        want = stencils.stats_images_plain(*args, **sargs)
        torch.cuda.synchronize()
        held = hold_stats(cell, gray, args, sargs, got, want, sat)
        center = sargs["center_patch_half"] is not None
        row = {"cell": cell, "shape": [n, *hw], "knobs": knobs, "smooth_max_abs_diff": float(diff.max()),
               "smooth_max_diff_over_bound": float((diff / bound.clamp(min=1e-30)).max()), **held}
        errs = {"stencil_smooth": row["smooth_max_abs_diff"],
                "stencil_stats": max(held["sat_max_abs_diff"], held["bright_blur_max_abs_diff"],
                                     held["bright_center_max_abs_diff"] or 0.0)}
        for name, fn, plain, nbytes in (
                ("stencil_smooth", lambda: stencils.smooth(gray, **kw), lambda: stencils.smooth_plain(gray, **kw),
                 kernels.min_bytes("stencil_smooth", n, *hw)),
                ("stencil_stats", lambda: stencils.stats_images(*args, **sargs),
                 lambda: stencils.stats_images_plain(*args, **sargs),
                 kernels.min_bytes("stencil_stats", n, *hw, center=center))):
            ms = cuda_ms(fn)
            n_dev, dev_ms = profiling.graph_kernels(fn)
            plain_ms = cuda_ms(plain, reps=10)
            n_plain, plain_dev_ms = profiling.graph_kernels(plain, reps=10)
            row[name] = {"ms": ms, "device_ms": dev_ms, "device_kernels_per_call": n_dev, "bytes": nbytes,
                         "bound_ms": bound_ms(nbytes), "bound_share": bound_ms(nbytes) / dev_ms,
                         "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms, "plain_device_kernels": n_plain,
                         "max_abs_err": errs[name]}
            print(f"stencils {name} [{cell} ({n}, {hw[0]}, {hw[1]})]: kernel {ms:.4f} ms (graph replay "
                  f"{dev_ms:.4f} device ms, {n_dev} device kernels), bound {bound_ms(nbytes):.4f} ms "
                  f"({nbytes} B, {bound_ms(nbytes) / dev_ms:.1%} of it), former matmul route (plain) "
                  f"{plain_ms:.4f} ms ({plain_dev_ms:.4f} device ms, {n_plain} device kernels); {smi}", flush=True)
        centre_txt = (f", bright_center max |d| {row['bright_center_max_abs_diff']:.3e}" if center else "")
        print(f"stencils held [{cell}]: smoothed max |d| {row['smooth_max_abs_diff']:.3e} "
              f"({row['smooth_max_diff_over_bound']:.3f} of the bound), centroids equal, sat max |d| "
              f"{row['sat_max_abs_diff']:.3e}, sat_mask {row['sat_mask_differ']} pixels differ "
              f"({row['sat_mask_ties']} ties), bright_blur {row['bright_blur_differ']} pixels differ "
              f"(max |d| {row['bright_blur_max_abs_diff']:.3e}){centre_txt}", flush=True)
        out["sites"].append(row)
        del gray, smoothed, former, diff, bound, pre, args, got, want, sat
        torch.cuda.empty_cache()
    # The kernel route against the former matmul route through the front
    # stage and the whole detector, on each pool's frames: the stencils
    # equal the matmuls bit for bit there, so nothing may differ.
    for hw, views in pools.items():
        cfg = CylinderDetectConfig(height=hw[0], width=hw[1], use_pallas=True)
        margin = detector._border_margin(cfg)

        def preprocess(smoothed):
            return frontend.preprocess_binarize(smoothed, margin=margin, joint_peak_iters=cfg.joint_peak_iters,
                                                pre_smoothed=True)

        pre_k = preprocess(stencils.smooth(views))
        pre_m = preprocess(stencils.smooth_plain(views))
        det_k = detector.detect_grid(views, cfg)
        front_k = detector.front_stage(views, cfg)
        with matmul_route(stencils):
            det_m = detector.detect_grid(views, cfg)
            front_m = detector.front_stage(views, cfg)
        torch.cuda.synchronize()
        both = det_k.grid.valid & det_m.grid.valid
        dxy = (det_k.grid.xy - det_m.grid.xy).abs().amax(-1)
        row = {"frames": list(views.shape), "binary_differ": int((pre_k[0] != pre_m[0]).sum()),
               "joint_peaks_differ": int((pre_k[5] != pre_m[5]).sum()),
               "sat_mask_differ": int((front_k.sat_mask != front_m.sat_mask).sum()),
               "centroids_differ": int((front_k.cents != front_m.cents).any(-1).sum()),
               "grid_valid_differ": int((det_k.grid.valid != det_m.grid.valid).sum()),
               "grid_ids_differ": int(((det_k.grid.idx != det_m.grid.idx).any(-1) & both).sum()),
               "grid_max_dxy_px": float(torch.where(both, dxy, 0.0).max()),
               "ok_differ": int((det_k.ok != det_m.ok).sum())}
        print(f"stencils vs matmul route, {views.shape[0]} views {hw[0]}x{hw[1]}: {row['binary_differ']} binary "
              f"pixels, {row['joint_peaks_differ']} joint peaks, {row['sat_mask_differ']} sat_mask pixels, "
              f"{row['centroids_differ']} centroids, {row['grid_valid_differ']} grid points' validity and "
              f"{row['grid_ids_differ']} ids differ, max |dxy| {row['grid_max_dxy_px']:.3e} px, "
              f"{row['ok_differ']} ok flags", flush=True)
        differ = {k: v for k, v in row.items() if k != "frames" and v}
        if differ:
            raise AssertionError(f"stencils vs matmul route at {hw[0]}x{hw[1]}: {differ}")
        out["routes"].append(row)
    print(json.dumps({"stencils": out}), flush=True)
    return out


def mesh_rank(mesh, stream_frames: int, chunk: int) -> dict:
    """Phase 16 on one rank of a mesh (``parallel.dryrun.launch``): the main
    configuration at 480x640 on MESH_FRAMES frames of ``example_pair``
    through ``sharded_pipeline``, then the compact stream over
    ``stream_frames`` uint8 frames (phase 10's scheme) at ``chunk`` with the
    mesh.  First every kernel call of both at this rank's shapes is held to
    its plain version; then the two run as the main path, counters reset
    just before and read just after.  Rank 0 then runs both unsharded and
    holds the sharded results to them (``dryrun.held``; frames 0-5 also to
    the golden fixture by the phase-2 contract, the registration by phase
    8's)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.ops import frontend
    from cylinder_pose_estimation_tpu_torch.parallel.dryrun import digest, held
    from cylinder_pose_estimation_tpu_torch.parallel.mesh import frame_slice, gather_frames
    from cylinder_pose_estimation_tpu_torch.parallel.sharding import sharded_pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils import profiling
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import TiledFrames, example_pair, registration_angles

    dev, n = mesh.device, MESH_FRAMES
    st_np, (i1, i2) = example_pair(480, 640, n_frames=n)
    stereo = stereo_from_numpy(*st_np, device=dev)
    cfg = CylinderDetectConfig(height=480, width=640, use_pallas=True)
    fit_cfg = FitConfig()
    angles = registration_angles(n)
    pipe = sharded_pipeline(mesh, stereo, cfg, fit_cfg)
    _, (p1, p2) = example_pair(480, 640, n_frames=STREAM_POOL, pans=[i % 13 for i in range(STREAM_POOL)])
    p1, p2 = (np.clip(p, 0, 255).astype(np.uint8) for p in (p1, p2))

    def stream(frames, on_mesh):
        return pipeline.estimate_poses_stream(TiledFrames(p1, frames), TiledFrames(p2, frames), stereo, cfg,
                                              fit_cfg, chunk=chunk, compact=True,
                                              mesh=mesh if on_mesh else None, device=None if on_mesh else dev)

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.group)

    # Every kernel call at this rank's shapes against plain (and the warm-up).
    with Capture(frontend) as cap:
        pipe(i1, i2, angles)
        stream(2 * chunk, True)
    calls = hold_calls(frontend, cap.calls, f"rank {mesh.rank}")
    del cap
    torch.cuda.empty_cache()

    # The main path: counters reset just before and read just after (the
    # compiled steps captured above are dropped, so this run captures its
    # own and launches through the wrappers).
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    batch, reg = pipe(i1, i2, angles)
    sync()
    t0 = time.perf_counter()
    out = stream(stream_frames, True)
    walls = [time.perf_counter() - t0]
    launches, replays = card_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    regs = gather_frames(reg.t_cam_agv[None], mesh)

    # The stream's wall time on all ranks and on rank 0 alone (the others
    # waiting), in alternating turns.
    walls_one, ref_out = [], None
    for k in range(MESH_TIMING_PAIRS):
        for on_mesh in ((False, True) if k % 2 == 0 else (True, False)):
            sync()
            if on_mesh or mesh.rank == 0:
                t0 = time.perf_counter()
                r = stream(stream_frames, on_mesh)
                (walls if on_mesh else walls_one).append(time.perf_counter() - t0)
                ref_out = ref_out if on_mesh else r

    # Device kernels of this rank's detect step, one rank at a time.
    start, stop = frame_slice(mesh, n)
    a = torch.as_tensor(i1[start:stop], device=dev)
    b = torch.as_tensor(i2[start:stop], device=dev)
    n_dev = dev_ms = None
    for r in range(mesh.size):
        if r == mesh.rank:
            n_dev, dev_ms = profiling.graph_kernels(
                lambda: pipeline.estimate_poses_batch(a, b, stereo, cfg, fit_cfg, probe="detect").grid.xy)
        sync()
    res = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend, "launches": launches,
           "graph_replays": replays,
           "calls_held": calls, "stream_s": walls, "peak_mib": peak / 2**20,
           "detect_step_device_kernels": n_dev, "detect_step_device_ms": dev_ms,
           "digest": [digest(batch), digest(reg), digest(out)],
           "t_cam_agv_ranks_equal": bool(all(torch.equal(regs[0], t) for t in regs))}
    if mesh.rank == 0:
        ref = pipeline.estimate_poses_batch(torch.as_tensor(i1, device=dev), torch.as_tensor(i2, device=dev),
                                            stereo, cfg, fit_cfg)
        ref_reg = pipeline.register_sequence(ref, torch.as_tensor(angles, device=dev))
        res["batch"] = held(batch, ref)
        with open(GOLDEN) as f:
            golden = {g["scene"]: g for g in json.load(f)["scenes"]}
        res["golden"] = [golden_check(batch, golden[s], s) for s in range(6)]
        res["registration"] = registration_check(reg, reg_dict(ref_reg), angles, "mesh registration")
        res["stream_1rank_s"] = walls_one
        res["stream"] = held(out, ref_out)
        res["stream_ok_frames"] = int(out.ok.sum())
    sync()
    return res


def mesh_ranks(ranks: int, ranks_per_card: int, smi: str) -> dict:
    """``mesh_rank`` on ``ranks`` spawned processes (``parallel.dryrun.
    launch``), checked and printed; the launches summed over the ranks."""
    from cylinder_pose_estimation_tpu_torch.parallel.dryrun import launch

    results = launch(mesh_rank, (MESH_STREAM_FRAMES, STREAM_CHUNK), ranks=ranks, device="cuda",
                     ranks_per_card=ranks_per_card, timeout=600)
    r0 = results[0]
    label = f"mesh {ranks} ranks on {-(-ranks // ranks_per_card)} card(s), {r0['backend']}"
    for r in results:
        for k, want in PATH_KERNELS["mesh_ranks"].items():
            if want is None and r["launches"][k] < 1:
                raise AssertionError(f"{label}: rank {r['rank']} never launched {k}")
        if r["digest"] != r0["digest"] or not r["t_cam_agv_ranks_equal"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s result differs from rank 0's")
        dev = (f"{r['detect_step_device_kernels']} device kernels, {r['detect_step_device_ms']:.4f} device ms "
               "(graph replay)")
        print(f"{label}: rank {r['rank']} on {r['device']}: kernel calls held equal to plain "
              f"{r['calls_held']}; detect step of {MESH_FRAMES // ranks} frames: {dev}; peak device memory "
              f"{r['peak_mib']:.1f} MiB; stream {MESH_STREAM_FRAMES} frames in "
              f"{[round(x, 3) for x in r['stream_s']]} s; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} } ({r['graph_replays']} graph replays)", flush=True)
    for name in ("batch", "stream"):
        if not r0[name]["ok"]:
            raise AssertionError(f"{label}: the sharded {name} breaks its contract against the unsharded one: "
                                 f"{r0[name]}")
    # Each turn's wall time over the ranks is its slowest rank's.
    fps_n = [MESH_STREAM_FRAMES / max(w) for w in zip(*(r["stream_s"] for r in results))]
    fps_1 = [MESH_STREAM_FRAMES / w for w in r0["stream_1rank_s"]]
    g = r0["golden"]
    print(f"{label}: sharded_pipeline on {MESH_FRAMES} frames vs unsharded: {r0['batch']}; golden scenes 0-5 "
          f"max|dxy| {max(x['max_dxy'] for x in g):.6f} px, max|dparams| {max(x['max_dparams'] for x in g):.6f}; "
          f"registration vs unsharded: axes {r0['registration']['axis_deg']:.3e} deg, fval rel "
          f"{r0['registration']['fval_rel']:.2e}; ranks agree", flush=True)
    print(f"{label}: stream N={MESH_STREAM_FRAMES} chunk={STREAM_CHUNK} compact, frames/s by turn: {ranks} ranks "
          f"{[round(x, 2) for x in fps_n]} (the first: the main path's run), 1 rank {[round(x, 2) for x in fps_1]}; "
          f"median ratio {statistics.median(fps_n[1:]) / statistics.median(fps_1):.3f}; ok "
          f"{r0['stream_ok_frames']}/{MESH_STREAM_FRAMES}; vs unsharded {r0['stream']}; {smi}", flush=True)
    GRAPH_REPLAYS[f"mesh {ranks} ranks, {ranks_per_card} a card"] = sum(r["graph_replays"] for r in results)
    return {k: sum(r["launches"][k] for r in results) for k in r0["launches"]}


def mesh_phase(device, cfg, fit_cfg, smi, experiment) -> dict:
    """Phase 16: (a) ``sharded_pipeline`` over a one-rank NCCL group on
    phase 8's 100 frames, counters reset just before and read just after,
    against phase 8's unsharded result; (b) ``mesh_rank`` on
    MESH_RANKS_PER_CARD ranks sharing this card (gloo, the check mode);
    (c) with two cards or more, on 2 or 4 NCCL ranks, one per card."""
    import tempfile

    import torch
    import torch.distributed as dist

    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.parallel.dryrun import digest
    from cylinder_pose_estimation_tpu_torch.parallel.mesh import TIMEOUT, make_mesh
    from cylinder_pose_estimation_tpu_torch.parallel.sharding import sharded_pipeline

    i1, i2, ang = experiment["frames"]
    with tempfile.TemporaryDirectory(prefix="cpe_mesh_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1, timeout=TIMEOUT, device_id=device)
        try:
            fn = sharded_pipeline(make_mesh(devices=[device]), experiment["stereo"], cfg, fit_cfg)
            (batch, reg), launches = run_path("mesh", lambda: fn(i1, i2, ang))
        finally:
            dist.destroy_process_group()
    batch = pipeline._tree_map(lambda x: x.cpu(), batch)
    want, want_reg = pipeline._tree_map(lambda x: x.cpu(), experiment["batch"]), experiment["reg"]
    for view in ("detect1", "detect2"):
        g, w = getattr(batch, view), getattr(want, view)
        for f in range(len(ang)):
            points_check(g.grid, f, grid_records(w, f), f"mesh {view} frame {f}")
        if not torch.equal(g.ok, w.ok):
            raise AssertionError(f"mesh {view}: ok differs from the unsharded experiment")
    chk = registration_check(reg, reg_dict(want_reg), ang, "mesh registration, 1 rank vs phase 8")
    print(f"mesh 1 rank NCCL, F={len(ang)} 480x640: ids and ok equal to phase 8, registration axes "
          f"{chk['axis_deg']:.3e} deg, perp {chk['perp_mm']:.3e} mm, fval rel {chk['fval_rel']:.2e}; bit-equal "
          f"batch {digest(batch) == digest(want)}, registration {digest(reg) == digest(want_reg)}", flush=True)
    del batch, reg
    torch.cuda.empty_cache()
    out = {"mesh": launches, "mesh_ranks": mesh_ranks(MESH_RANKS_PER_CARD, MESH_RANKS_PER_CARD, smi)}
    if torch.cuda.device_count() >= 2:
        out["mesh_cards"] = mesh_ranks(4 if torch.cuda.device_count() >= 4 else 2, 1, smi)
    return out


def leaf_diffs(got, want, prefix="") -> list:
    """(leaf name, differing elements, largest |difference|) of every leaf
    of two equal NamedTuple trees that is not ``torch.equal`` (NaN equal to
    NaN); [] when every leaf is."""
    import torch

    if isinstance(got, tuple):
        names = getattr(got, "_fields", range(len(got)))
        return [d for name, g, w in zip(names, got, want) for d in leaf_diffs(g, w, f"{prefix}.{name}")]
    g, w = got.detach().cpu(), want.detach().cpu()
    if g.shape != w.shape or g.dtype != w.dtype:
        return [(prefix, -1, float("inf"))]
    differ = g != w
    if g.is_floating_point():
        differ &= ~(torch.isnan(g) & torch.isnan(w))
    n = int(differ.sum())
    if n == 0:
        return []
    d = (g.double() - w.double()).abs()[differ]
    return [(prefix, n, float(d[torch.isfinite(d)].max()) if torch.isfinite(d).any() else float("inf"))]


def compiled_phase(device, stereo, frames, cfgs, fit_cfg, experiment, smi, full_hd, sites) -> dict:
    """Phase 19: the compiled steps (``pipeline.compiled_batch``, the
    registration step of ``register_sequence``, ``pipeline._stream_step``)
    against the eager calls they replay.  For each step: the first call
    (eager) and the second (eager warm-up, capture, replay) timed on their
    own; every leaf of the second's replay against the eager call on the
    same inputs (``torch.equal``, else
    the count and the largest difference: a fault); the host
    synchronisations of one compiled call (``sync_sites``, must be 0); the
    kernel nodes of the graph captured from one call and the device ms of
    its replay (``profiling.graph_kernels``), and with every solve the
    plain version.  ``full_hd``: (label, rig, frames, config) of the
    full-HD batch step, run as the 480x640 ones; every kernel-wrapper call
    of its eager call is recorded and held to its plain version on the same
    inputs, timed, into the ``large_sites`` of the kernel report ``sites``
    (``hold_sites``)."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.ops import frontend, linalg
    from cylinder_pose_estimation_tpu_torch.utils import profiling

    out = {}

    def first_calls(label, fn, kind="batch", scan_cc=0):
        """The second call's result, and the MiB the device reserves for the
        step after it, of a step's first call (eager) and second (warm-up,
        capture, replay), each timed on its own and printed; the capture
        must record ``SOLVES_PER_CAPTURE[kind]`` kernel solves and
        ``scan_cc`` launches of the XLA branch's CC."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pipeline.reset_graph_launch_counts()
        before = torch.cuda.memory_reserved(device)
        seconds = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
        pool = (torch.cuda.memory_reserved(device) - before) / 2**20
        captured = pipeline.graph_launch_counts()["captured"]
        solves, ccs = captured.get("solve_spd", 0), captured.get("scan_cc", 0)
        print(f"compiled {label}: first call (eager) {seconds[0]:.3f} s, second (warm-up, capture, replay) "
              f"{seconds[1]:.3f} s; the graph's memory pool {pool:.1f} MiB; solve_spd launches per capture "
              f"{solves}, scan_cc {ccs}; {smi}", flush=True)
        if solves != SOLVES_PER_CAPTURE[kind]:
            raise AssertionError(f"compiled {label}: the capture recorded {solves} kernel solves, "
                                 f"not {SOLVES_PER_CAPTURE[kind]}")
        if ccs != scan_cc:
            raise AssertionError(f"compiled {label}: the capture recorded {ccs} scan_cc launches, not {scan_cc}")
        return res, {"first_call_s": seconds[0], "second_call_s": seconds[1], "pool_mib": pool,
                     "solve_spd_per_capture": solves, "scan_cc_per_capture": ccs}

    def check(label, got, want, n_frames, compiled_fn, capture_fn):
        diffs = leaf_diffs(got, want)
        for leaf, n, d in diffs:
            print(f"compiled {label}: leaf {leaf} differs from the eager call in {n} elements, "
                  f"largest |d| {d:.3e}", flush=True)
        if diffs:
            raise AssertionError(f"compiled {label}: replay differs from the eager call ({len(diffs)} leaves)")
        sites = sync_sites(compiled_fn)
        if sites:
            raise AssertionError(f"compiled {label}: one compiled call synchronises with the host: {sites}")
        n_kernels, dev_ms = profiling.graph_kernels(capture_fn, reps=5, warmup=1)
        with solve_spd_as(linalg.solve_spd_plain):
            n_plain, _ = profiling.graph_kernels(capture_fn, reps=1, warmup=0)
        print(f"compiled {label}: kernel nodes per step {n_plain} with every solve plain, {n_kernels} with the "
              f"solve kernel", flush=True)
        if n_kernels >= n_plain:
            raise AssertionError(f"compiled {label}: the solve kernel leaves {n_kernels} of {n_plain} nodes")
        print(f"compiled {label}: replay equal to eager on every leaf; host syncs per compiled call 0; "
              f"{n_kernels} kernel nodes per step, replay {dev_ms:.4f} device ms; {smi}", flush=True)
        return {"kernel_nodes": n_kernels, "kernel_nodes_plain_solve": n_plain, "replay_device_ms": dev_ms,
                "frames": n_frames}

    steps = [(label, stereo, frames, cfg) for label, cfg in cfgs.items()] + [full_hd]
    for label, rig, (d1, d2), cfg in steps:
        n = d1.shape[0]
        step = pipeline.compiled_batch(rig, cfg, fit_cfg)
        got, first = first_calls(f"{label} B={n}", lambda: step(d1, d2),
                                 scan_cc=0 if cfg.use_pallas else SCAN_CC_PER_STEP)
        with Capture(frontend) if label == full_hd[0] else contextlib.nullcontext() as cap:
            want = pipeline.estimate_poses_batch(d1, d2, rig, cfg, fit_cfg)
        out[label] = check(f"{label} B={n}", got, want, n, lambda: step(d1, d2),
                           lambda cfg=cfg: pipeline.estimate_poses_batch(d1, d2, rig, cfg, fit_cfg))
        out[label].update(first)
        del step, got, want
        if cap is not None:
            hold_sites(sites, frontend, cap.calls, f"compiled {label} B={n}", True)
            del cap
        pipeline._STREAM_STEP_CACHE.clear()
    print("compiled batch steps, kernel nodes per step: " + ", ".join(
        f"{label} {out[label]['kernel_nodes']} ({out[label]['frames']} frames)" for label, *_ in steps)
        + f"; {smi}", flush=True)
    d1, d2 = frames
    n = d1.shape[0]

    # The experiment's registration step (phase 8's 100 frames and batch).
    batch, ang = experiment["batch"], torch.as_tensor(experiment["frames"][2], device=device)
    reg_cfg = RegistrationConfig()
    health = pipeline.frame_health(batch, reg_cfg)

    def eager_reg():
        return fit_cylinders_with_angles(batch.fit.points3, batch.fit.points_valid, ang, reg_cfg,
                                         frame_valid=health)

    f_reg = batch.fit.points3.shape[0]
    got, first = first_calls(f"registration F={f_reg}", lambda: pipeline.register_sequence(batch, ang, reg_cfg),
                             kind="registration")
    out["registration"] = check(f"registration F={f_reg}", got, eager_reg(), f_reg,
                                lambda: pipeline.register_sequence(batch, ang, reg_cfg), eager_reg)
    out["registration"].update(first)
    pipeline._STREAM_STEP_CACHE.clear()

    # The stream's chunk step at STREAM_CHUNK frames (compact), on the
    # phase-2 frames tiled to the chunk.
    idx = [i % n for i in range(STREAM_CHUNK)]
    c1, c2 = d1[idx].round().clamp(0, 255).to(torch.uint8), d2[idx].round().clamp(0, 255).to(torch.uint8)
    cfg = cfgs["main"]
    step = pipeline._stream_step(stereo, cfg, fit_cfg, reg_cfg, True)

    def eager_chunk(a, b):
        return pipeline._summarize_batch(pipeline.estimate_poses_batch(a, b, stereo, cfg, fit_cfg), reg_cfg)

    got, first = first_calls(f"stream chunk {STREAM_CHUNK}",
                             lambda: pipeline._tree_map(torch.clone, step(c1, c2)))
    out["stream"] = check(f"stream chunk {STREAM_CHUNK}", got, eager_chunk(c1, c2), STREAM_CHUNK,
                          lambda: step(c1, c2), lambda: eager_chunk(c1, c2))
    out["stream"].update(first)
    pipeline._STREAM_STEP_CACHE.clear()
    return out


def main() -> int:
    import torch

    # The first line, before anything that can fail: the versions in use.
    print(f"chip_smoke: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} CUDA devices", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    from cylinder_pose_estimation_tpu_torch.config import (
        CylinderDetectConfig,
        FitConfig,
        PlaneDetectConfig,
    )
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.models.pipeline import estimate_poses_batch
    from cylinder_pose_estimation_tpu_torch.ops import frontend, kernels
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
    from cylinder_pose_estimation_tpu_torch.utils import profiling
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
        apply_gap,
        example_pair,
        plane_view,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    print(f"device {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    PATH_KERNELS.update(path_kernels())

    t0 = time.perf_counter()
    kernels.build()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({kernels.BUILD_DIR})", flush=True)
    for ln in ptxas_report(kernels.BUILD_DIR):
        print(f"ptxas: {ln}", flush=True)

    height, width, batch = 480, 640, 16
    stereo_np, (i1, i2) = example_pair(height, width, n_frames=batch)
    stereo = stereo_from_numpy(*stereo_np, device=device)
    cfg = CylinderDetectConfig(height=height, width=width, use_pallas=True)
    cfg_ep = CylinderDetectConfig(height=height, width=width, use_pallas=True,
                                  bridge_endpoint_stats=True)
    cfg_plane = PlaneDetectConfig(height=height, width=width, use_pallas=True, roi_threshold=30.0)
    cfg_xla = CylinderDetectConfig(height=height, width=width)
    fit_cfg = FitConfig()
    print(f"plan preprocess_binarize (2B, {height}, {width}): "
          f"{frontend.preprocess_plan(2 * batch, height, width, joint_peak_iters=cfg.joint_peak_iters)}",
          flush=True)
    for shape in ((2 * 2 * batch, 128, 256), (2 * 2 * batch, 240, 384)):
        print(f"plan connected_components {shape}: {frontend.cc_plan(*shape)}", flush=True)
    print(f"plan component_payload_minmax (4B, 240, 384): {frontend.cc_plan(4 * batch, 240, 384, channels=2)}",
          flush=True)
    print(f"plan bridge_morphology (4B, 240, 384): {frontend.bridge_plan(4 * batch, 240, 384)}", flush=True)
    for shape in ((4 * batch, 480, 640), (batch, 480, 640), (4 * LARGE_BATCH, 360, 640),
                  (4 * LARGE_BATCH, 544, 1024), *ROUTE_SHAPES.values()):
        print(f"plan bridge_morphology {shape}: {frontend.bridge_plan(*shape)}", flush=True)
    for shape, ch, pools in (((4 * batch, 480, 640), 1, 2), ((4 * batch, 480, 640), 2, 4),
                             ((4 * LARGE_BATCH, 360, 640), 1, 2), ((4 * LARGE_BATCH, 544, 1024), 2, 4)):
        print(f"plan global route {shape} channels {ch} pools {pools}: "
              f"{frontend.cc_plan(*shape, channels=ch, pools_per_round=pools)}", flush=True)
    with open(GOLDEN) as f:
        golden = json.load(f)["scenes"]
    with open(ENDPOINT) as f:
        endpoint_fix = json.load(f)["scenes"]
    with open(PLANE) as f:
        plane_views = json.load(f)["views"]

    # --- main path: the golden scenes, counters reset just before ---------
    names = list(range(6)) + ["gap0_pallas"]
    a = np.concatenate([i1[:6], apply_gap(i1[0])[None]])
    b = np.concatenate([i2[:6], apply_gap(i2[0])[None]])
    a = torch.as_tensor(a, device=device)
    b = torch.as_tensor(b, device=device)
    res, main_launches = run_path("main", lambda: estimate_poses_batch(a, b, stereo, cfg, fit_cfg))
    for s, name in enumerate(names):
        want = next(g for g in golden if g["scene"] == name)
        chk = golden_check(res, want, s)
        if name == "gap0_pallas" and chk["bridged_components"] != want["bridged_components"]:
            raise AssertionError(f"gap scene bridged {chk['bridged_components']} vs {want['bridged_components']}")
        print(f"scene {name}: points {chk['n_view1']}/{chk['n_view2']}, max|dxy| {chk['max_dxy']:.6f} px, "
              f"max|dparams| {chk['max_dparams']:.6f}, |dreproj| {chk['d_reproj']:.6f} px, "
              f"bridged_components {chk['bridged_components']}", flush=True)

    # --- endpoint path: the same scenes, counters reset just before -------
    res, ep_launches = run_path("endpoint", lambda: estimate_poses_batch(a, b, stereo, cfg_ep, fit_cfg))
    for s, name in enumerate(names):
        want = next(g for g in endpoint_fix if g["scene"] == name)
        chk = golden_check(res, want, s, gauge=True)
        if chk["bridged_components"] != want["bridged_components"]:
            raise AssertionError(f"endpoint scene {name} bridged {chk['bridged_components']} "
                                 f"vs {want['bridged_components']}")
        print(f"endpoint scene {name}: points {chk['n_view1']}/{chk['n_view2']}, "
              f"max|dxy| {chk['max_dxy']:.6f} px, max|dparams| {chk['max_dparams']:.6f} "
              f"(direction at the fixture's norm; raw {chk['max_dparams_raw']:.6f}), "
              f"|dreproj| {chk['d_reproj']:.6f} px, bridged_components {chk['bridged_components']}",
              flush=True)

    # --- plane path: the fixture's views, counters reset just before ------
    pviews = torch.as_tensor(np.stack([plane_view(height, width, **v["spec"]) for v in plane_views]),
                             device=device)
    det, plane_launches = run_path("plane", lambda: detect_grid(pviews, cfg_plane))
    chk = plane_check(det, plane_views)
    print(f"plane views: points {chk['points']}, max|dxy| {chk['max_dxy']:.6f} px", flush=True)

    # --- the XLA branch (the default config): no kernel may launch -------
    xla_launches = xla_phase(a, b, stereo, pviews, golden, plane_views, fit_cfg)

    # --- the experiment, preprocessing and stream paths ---------------------
    def stereo_fn(st):
        return stereo_from_numpy(*st, device=device)

    exp_launches, experiment = registration_phase(device, stereo_fn, cfg, fit_cfg, smi)
    pre_launches = preprocess_phase(device, stereo_fn, cfg, fit_cfg, smi)
    stream_launches = stream_phase(device, stereo, cfg, fit_cfg, smi)

    # --- numerics: the bridge on the card vs on the CPU --------------------
    for label, views, c in (("main", torch.cat([a, b]), cfg), ("endpoint", torch.cat([a, b]), cfg_ep),
                            ("plane", pviews, cfg_plane)):
        d_ang, flips = bridge_flips(views, c)
        print(f"{label} bridge, card vs CPU on the same carved masks ({views.shape[0]} views): "
              f"max |d angle| {d_ang:.3e} rad, {flips} differing bridged pixels", flush=True)

    # --- kernels vs plain on the B=16 intermediates -----------------------
    d1 = torch.as_tensor(i1, device=device)
    d2 = torch.as_tensor(i2, device=device)
    with Capture(frontend) as cap:
        estimate_poses_batch(d1, d2, stereo, cfg, fit_cfg)
    with Capture(frontend) as cap_ep:
        estimate_poses_batch(d1, d2, stereo, cfg_ep, fit_cfg)
    cap.calls["component_payload_minmax"] = cap_ep.calls["component_payload_minmax"]
    with Capture(frontend) as cap_xla:
        estimate_poses_batch(d1, d2, stereo, cfg_xla, fit_cfg)
    if len(cap_xla.calls["scan_cc"]) != SCAN_CC_PER_STEP:
        raise AssertionError(f"the default B={batch} step called the XLA CC {len(cap_xla.calls['scan_cc'])} times")
    with torch.inference_mode():
        report = kernel_phase(frontend, cap.calls, device)
        solve_phase(report, lambda: estimate_poses_batch(d1, d2, stereo, cfg, fit_cfg))
        # The XLA branch's CC at the default step's three sites.
        hold_sites(report, frontend, cap_xla.calls, f"xla B={batch}", True, into=None)

    # --- large frames: the CC family's global route, the bridge's split ---
    # (after the kernel phase: torch.profiler read no device activity in its
    # first session when the registration and stream phases ran between two
    # of its uses)
    large_launches, large_report = large_phase(frontend, device, fit_cfg, smi)

    # --- the full-resolution variants and refinement (profiled as well) ---
    variant_launches, variant_report = variants_phase(frontend, device, fit_cfg, smi)

    # --- each route of the bridge once (profiled as well) -----------------
    route_launches, route_report = routes_phase(frontend, device)

    # --- end to end timing at B=16 of the endpoint and plane paths ---------
    # (the main and XLA paths' B=16 steps are the benchmark's cells). Every
    # call perturbs the frames anew, as bench.py does.
    rep = itertools.count(1)

    def e2e_ep():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_ep, fit_cfg).fit.params

    def detect_ep():
        eps = 1e-4 * next(rep)
        return estimate_poses_batch(d1 + eps, d2 + eps, stereo, cfg_ep, fit_cfg, probe="detect").grid.xy

    def detect_plane():
        eps = 1e-4 * next(rep)
        return detect_grid(pviews + eps, cfg_plane).grid.xy

    ms_e2e = cuda_ms(e2e_ep, reps=10, warmup=2)
    ms_det = cuda_ms(detect_ep, reps=10, warmup=2)
    n_dev, dev_ms = profiling.graph_kernels(detect_ep, reps=10, warmup=2)
    print(f"endpoint e2e B={batch} {height}x{width}: {ms_e2e / batch:.4f} ms/frame (detect {ms_det / batch:.4f} "
          f"ms/frame, fit {(ms_e2e - ms_det) / batch:.4f} ms/frame); detect step: {n_dev} device kernels, "
          f"{dev_ms:.4f} device ms (graph replay); {smi}", flush=True)
    stage_split(torch.cat([d1, d2]), (("main", cfg), ("endpoint", cfg_ep)))
    n_views = pviews.shape[0]
    ms_plane = cuda_ms(detect_plane, reps=10, warmup=2)
    print(f"plane detect V={n_views} {height}x{width}: {ms_plane / n_views:.4f} ms/view; {smi}",
          flush=True)

    # --- the compiled steps: replay against eager ------------------------
    hd_np, (h1, h2) = example_pair(*FULL_HD, n_frames=FULL_HD_BATCH,
                                   pans=[float(i % 13) for i in range(FULL_HD_BATCH)])
    full_hd = (f"main {FULL_HD[0]}x{FULL_HD[1]}", stereo_from_numpy(*hd_np, device=device),
               (torch.as_tensor(h1, device=device), torch.as_tensor(h2, device=device)),
               CylinderDetectConfig(height=FULL_HD[0], width=FULL_HD[1], use_pallas=True))
    compiled = compiled_phase(device, stereo, (d1, d2), {"main": cfg, "endpoint": cfg_ep, "xla": cfg_xla},
                              fit_cfg, experiment, smi, full_hd, large_report)

    # --- the command-line drivers on the card ------------------------------
    cli_launches = cli_phase(smi)

    # --- the mesh path: one NCCL rank, then ranks over torch.distributed ---
    mesh_launches = mesh_phase(device, cfg, fit_cfg, smi, experiment)

    # --- the JAX package's detection corpora, card against the CPU port ----
    corpus_launches = corpus_phase(frontend, device, torch.stack([a[0], a[6]]), smi)

    # --- the knobs: the kernels' smoothing and capped-scan branches --------
    knob_launches, knob_report = knobs_phase(frontend, device, fit_cfg, smi)

    # --- the front stage's stencils against the banded matmuls -------------
    stencil_report = stencil_phase(device, smi)

    # Launches per kernel: summed over the six path runs (each counted
    # from zero), with the split by path beside it.
    by_path = {"main": main_launches, "endpoint": ep_launches, "plane": plane_launches,
               "experiment": exp_launches, "preprocess": pre_launches, "stream": stream_launches,
               "xla": xla_launches, "large": large_launches, **variant_launches, "cli": cli_launches,
               "routes": route_launches, **mesh_launches, **corpus_launches, **knob_launches}
    # Rows: the front end's kernels, the bridge's split and global routes,
    # the knobs' branches, then the other kernels of the catalogue.
    front, stencil_rows = wrapped_in("frontend"), wrapped_in("stencils")
    names = (front + tuple(kernels.CATALOGUE["bridge_morphology"].counters)[1:] + tuple(KNOB_ROWS)
             + tuple(name for name in kernels.CATALOGUE if name not in front))
    rows = []
    for k in names:
        r = report.get(k, new_report())
        large = large_report.get(k, new_report())
        variant = variant_report.get(k, new_report())
        route = route_report.get(k, new_report())
        knob = knob_report.get(k, new_report())
        extra = large["large_sites"] + variant["variant_sites"] + route["route_sites"] + knob["knob_sites"]
        for label, ms_k, ms_p, nbytes, n_dev in r["sites"]:
            print(f"timing {k} [{label}]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
                  f"{bound_ms(nbytes):.4f} ms ({nbytes} B, {bound_ms(nbytes) / ms_k:.1%} of it), "
                  f"device kernels per call {n_dev}", flush=True)
        for site in extra:
            by_name = {n: round(v, 4) for n, v in (site["device_ms_by_kernel"] or {}).items()}
            print(f"timing {k} [{site['site']}]: kernel {site['ms']:.4f} ms (graph replay "
                  f"{site['device_ms']:.4f} device ms), plain {site['plain_ms']:.4f} ms, "
                  f"bound {site['bound_ms']:.4f} ms ({site['bytes']} B), device kernels per call "
                  f"{site['device_kernels_per_call']} {by_name}", flush=True)
        stencil_sites = []
        if k in front or k in ("solve_spd", "scan_cc"):  # the 480x640 sites
            ms, dev_ms, plain_ms, nbytes, n_dev = r["ms"], r["device_ms"], r["plain_ms"], r["bytes"], r["device_launches"]
        elif k in stencil_rows:  # phase 20's sites: the row's times at STENCIL_ROW_SITE, the others listed
            for x in stencil_report["sites"]:
                r["max_abs_err"] = max(r["max_abs_err"], x[k]["max_abs_err"])
                if x["cell"] == STENCIL_ROW_SITE:
                    t = x[k]
                else:
                    stencil_sites.append({"site": f"{x['cell']} {tuple(x['shape'])}", **x[k]})
            ms, dev_ms, plain_ms, nbytes, n_dev = (t["ms"], t["device_ms"], t["plain_ms"], t["bytes"],
                                                   t["device_kernels_per_call"])
        else:  # a bridge route or a knob's branch: its timed sites of phases 12, 13, 15 and 18
            ms, plain_ms = sum(x["ms"] for x in extra), sum(x["plain_ms"] for x in extra)
            nbytes = sum(x["bytes"] for x in extra)
            dev_ms = sum(x["device_ms"] for x in extra)
            n_dev = max(x["device_kernels_per_call"] for x in extra)
        count = "bridge_morphology.cluster" if k == "bridge_morphology" else k
        entry = kernels.CATALOGUE[k.split(".")[0]]
        step_path = KNOB_ROWS.get(k, "main")
        rows.append({
            "name": k, "route": "cuda", "source": os.path.relpath(kernels.CSRC / entry.source, HERE),
            "replaces": entry.counters.get(k) or entry.replaces,
            "launches": sum(c.get(count, 0) for c in by_path.values()),
            "launches_by_path": {p: c.get(count, 0) for p, c in by_path.items()},
            "graph_replays": GRAPH_REPLAYS,
            "launches_per_step": SCAN_CC_PER_STEP if k == "scan_cc" else by_path[step_path][count],
            "max_abs_err": max(r["max_abs_err"], large["max_abs_err"], variant["max_abs_err"], route["max_abs_err"],
                               knob["max_abs_err"]),
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
            "bound_share": bound_ms(nbytes) / ms if ms else None, "library_ms": None,
            "device_kernels_per_call": n_dev, "design": DESIGN[k],
            "large_sites": large["large_sites"], "variant_sites": variant["variant_sites"],
            "route_sites": route["route_sites"], "knob_sites": knob["knob_sites"], "stencil_sites": stencil_sites,
        })
    print(json.dumps({"compiled_steps": compiled, "card": smi}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
