"""The one seam between Python and the CUDA kernels in ``csrc/``: their
catalogue, build, launch, device route, input checks and launch counters.

``CATALOGUE`` holds one entry per hand-written kernel: its C entry points
with their signatures, its launch counters, its source, the JAX code it
stands for and the planes it must move.  A new kernel is registered here.

The ``.cu`` sources have a plain C interface (one entry function per kernel,
returning a ``cudaError_t``).  At first use ``nvcc`` compiles them, one
process per source, all at once, for ``sm_90a`` with ``--fmad=false`` (the
kernels must reproduce the reference's float association exactly, with no
multiply-add contraction), and links them into one shared library under
``cylinder_pose_estimation_tpu_torch/_build/``, named by a digest of the
sources and flags; ``ctypes`` binds every entry point of the catalogue.  A
C interface keeps PyTorch's headers out of the compile, which is what keeps
the build at seconds.  The wrappers (``ops/frontend``, ``ops/stencils``,
``ops/linalg.solve_spd``, ``ops/labeling.connected_components``) take
their device route from ``route`` (a CPU tensor runs the plain version, a
CUDA tensor launches the kernel), check their inputs with ``check``, pass
pointers and the current CUDA stream through ``launch``, which raises on a
non-zero return, and count each launching call with ``count``.  Nothing
here is built until a kernel runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from cylinder_pose_estimation_tpu_torch.utils import profiling

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "--fmad=false",
    "-std=c++17",
    "-Xptxas",
    "-v",
    "-Xcompiler",
    "-fPIC",
]
# Opt-in dynamic shared memory a block may use on Hopper (232,448 bytes).
MAX_DYNAMIC_SMEM = 232448


class Kernel(NamedTuple):
    """A hand-written kernel.  ``source``: its file under ``csrc/``;
    ``replaces``: the JAX code it stands for; ``wrapper``: the function of
    ``ops/`` that launches it.  ``entries``: its C entry points, each with
    (tensor pointers, ints, floats) before the CUDA stream.  ``counters``:
    its route and branch counters (its own counter is its name), each with
    the JAX code of the branch it counts (None: a route of the kernel's own
    code).  ``planes``: the ``itemsize``-wide planes an (n, h, w) call must
    move (None: it moves no such planes), ``byte_planes`` the one-byte
    ones; ``optional_plane``: the ``min_bytes`` flag that adds one more."""

    source: str
    replaces: str
    wrapper: str
    entries: Dict[str, Tuple[int, int, int]]
    counters: Dict[str, Optional[str]]
    planes: Optional[int]
    byte_planes: int = 0
    optional_plane: Optional[str] = None


_PALLAS = "cylinder_pose_estimation_tpu/ops/pallas/frontend.py"
# The four TPU kernels of the JAX package (its pallas_calls' functions, and
# the lines of the branches the counters count), the fit tail's SPD solve,
# the front stage's banded correlations and the XLA branch's connected
# components, which replace no pallas_call: the JAX code they compute.
CATALOGUE: Dict[str, Kernel] = {
    "preprocess_binarize": Kernel(
        "preprocess.cu", f"{_PALLAS}:286", "frontend.preprocess_binarize",
        {"cpe_smooth_wrapped": (3, 8, 0), "cpe_preprocess_binarize": (8, 13, 3)},
        # The kernel's own smoothing (``pre_smoothed=False``): its launches.
        {"preprocess_binarize.smoothing": f"{_PALLAS}:183"},
        planes=1 + 6),  # smoothed -> six planes
    "connected_components": Kernel(
        "connected_components.cu", f"{_PALLAS}:761", "frontend.connected_components",
        {"cpe_connected_components": (3, 8, 0), "cpe_connected_components_global": (4, 11, 0)},
        # Calls on the large-frame (band) route of ``cc_plan``, capped or not,
        # and the capped scans (``cap_axis``/``cap``), which all take it.
        {"connected_components.band": None, "connected_components.capped.band": f"{_PALLAS}:524"},
        planes=2, optional_plane="warm"),  # mask (+ initial labels) -> labels
    "bridge_morphology": Kernel(
        "bridge.cu", f"{_PALLAS}:475", "frontend.bridge_morphology",
        {"cpe_bridge_morphology": (6, 10, 0), "cpe_bridge_morphology_split": (6, 10, 0),
         "cpe_bridge_morphology_global": (7, 7, 0)},
        # The calls by route (``bridge_plan``); they add up to the kernel's.
        {"bridge_morphology.cluster": None, "bridge_morphology.split": None, "bridge_morphology.global": None},
        planes=3),  # masks, expandability -> bridged; the per-mask angle and length left out
    "component_payload_minmax": Kernel(
        "connected_components.cu", f"{_PALLAS}:711", "frontend.component_payload_minmax",
        {"cpe_component_payload_minmax": (4, 8, 0), "cpe_component_payload_minmax_global": (5, 11, 0)},
        {}, planes=4),  # mask, payload -> min, max
    "solve_spd": Kernel(
        "linalg.cu", "cylinder_pose_estimation_tpu/ops/linalg.py:113", "linalg.solve_spd",
        {"cpe_solve_spd_factor": (4, 3, 0), "cpe_solve_spd_refine": (4, 3, 0)}, {}, planes=None),
    "stencil_smooth": Kernel(
        "stencils.cu", "cylinder_pose_estimation_tpu/models/detector.py:1293", "stencils.smooth",
        {"cpe_stencil_smooth": (3, 7, 0)}, {}, planes=2),  # gray -> smoothed
    "stencil_stats": Kernel(
        "stencils.cu", "cylinder_pose_estimation_tpu/models/detector.py:252", "stencils.stats_images",
        {"cpe_stencil_stats": (10, 10, 1)}, {},
        # gray, joints, counts -> blur, cx, cy (+ the centre-seed image); the
        # saturation mask one byte a pixel.
        planes=6, byte_planes=1, optional_plane="center"),
    "scan_cc": Kernel(
        "scan_cc.cu", "cylinder_pose_estimation_tpu/ops/labeling.py:52", "labeling.connected_components",
        {"cpe_scan_cc": (3, 5, 0)}, {}, planes=1, byte_planes=1),  # mask -> labels
}
# Every C entry point's signature, and every launch counter (``kernel.<name>``
# in the registry of ``utils/profiling``), from the catalogue.
ENTRIES = {e: sig for k in CATALOGUE.values() for e, sig in k.entries.items()}
COUNTERS = tuple(c for name, k in CATALOGUE.items() for c in (name, *k.counters))

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libcpe_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        # One nvcc per source, all at once, then one link.
        nvcc = _nvcc()
        objs = BUILD_DIR / f"obj.{os.getpid()}"
        objs.mkdir(exist_ok=True)
        procs = []
        for src in sources:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp),
                *(str(objs / f"{src.stem}.o") for src in sources)]
        log, failed = [], []
        for cmd, proc in procs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(err[-4000:])
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr[-4000:])
        (BUILD_DIR / "build.log").write_text("".join(log))
        shutil.rmtree(objs, ignore_errors=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (n_ptr, n_int, n_float) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float
            + [ctypes.c_void_p]
        )
    lib.cpe_error_string.restype = ctypes.c_char_p
    lib.cpe_error_string.argtypes = [ctypes.c_int]
    lib.cpe_bridge_split_max_clusters.restype = ctypes.c_int
    lib.cpe_bridge_split_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return lib


def launch(
    name: str,
    tensors: Sequence[Optional[torch.Tensor]],
    ints: Sequence[int],
    floats: Sequence[float],
) -> None:
    """Call C entry ``name``(tensor pointers..., ints..., floats..., stream)
    on the current stream of the first tensor's device; raise on error."""
    if ENTRIES[name] != (len(tensors), len(ints), len(floats)):
        raise TypeError(f"{name} takes {ENTRIES[name]} (pointers, ints, floats)")
    lib = build()
    dev = next(t for t in tensors if t is not None).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [t.data_ptr() if t is not None else None for t in tensors]
    args += [int(i) for i in ints] + [float(f) for f in floats] + [stream]
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.cpe_error_string(rc).decode()}")


def bridge_split_max_clusters(elem_bytes: int, cluster: int, smem: int, device) -> int:
    """Clusters of the bridge's split kernel (``cluster`` CTAs of ``smem``
    shared bytes, pixels of ``elem_bytes``) that card ``device`` (the
    caller's: a ``torch.device`` or an index) holds at once
    (``cudaOccupancyMaxActiveClusters``); 0: the plan cannot launch."""
    lib = build()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.cpe_bridge_split_max_clusters(elem_bytes, cluster, smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cpe_bridge_split_max_clusters: CUDA error {rc}: {lib.cpe_error_string(rc).decode()}")
    return out.value


def route(x: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` (the argument ``name``) is a contiguous CUDA
    tensor of ``dtype`` with ``ndim`` dims."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def count(name: str) -> None:
    """Count one launching call on counter ``name`` of ``COUNTERS``."""
    if name not in COUNTERS:
        raise KeyError(f"{name} is not a launch counter of the catalogue")
    profiling.count(f"kernel.{name}")


def launch_counts() -> Dict[str, int]:
    """{counter: launching calls} of every counter of ``COUNTERS`` since
    the last ``reset_launch_counts`` (plain runs do not count)."""
    counts = profiling.counters("kernel.")
    return {k: counts.get(f"kernel.{k}", 0) for k in COUNTERS}


def reset_launch_counts() -> None:
    profiling.reset_counters("kernel.")


def min_bytes(name: str, n: int, h: int, w: int, *, warm: bool = False, itemsize: int = 4,
              center: bool = False) -> int:
    """The bytes kernel ``name`` must move for an (n, h, w) call: each input
    plane read once and each output plane written once, ``itemsize`` bytes
    a pixel (1: the bridge's bool interface), one-byte planes at one.
    ``warm``: the CC call reads initial labels too; ``center``: the
    statistic images with the centre-seed image.  Raises ``KeyError`` for a
    name the catalogue does not hold."""
    k = CATALOGUE[name]
    if k.planes is None:
        raise ValueError(f"{name} moves no (n, h, w) planes")
    extra = {"warm": warm, "center": center}.get(k.optional_plane, False)
    return (itemsize * (k.planes + int(extra)) + k.byte_planes) * n * h * w
