"""Build and bind the CUDA kernels in ``csrc/``.

The ``.cu`` sources have a plain C interface (one entry function per kernel,
returning a ``cudaError_t``).  At first use ``nvcc`` compiles them, one
process per source, all at once, for ``sm_90a`` with ``--fmad=false`` (the
kernels must reproduce the reference's float association exactly, with no
multiply-add contraction), and links them into one shared library under
``cylinder_pose_estimation_tpu_torch/_build/``, named by a digest of the
sources and flags; ``ctypes`` loads it.  A C interface keeps
PyTorch's headers out of the compile, which is what keeps the build at
seconds: the wrappers in ``ops/frontend.py`` do the device, dtype, shape and
contiguity checks, pass pointers and the current CUDA stream, and raise on a
non-zero return.  Nothing here is imported or built until a kernel runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

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
# C entry points: (tensor pointers, ints, floats), then the CUDA stream.
SIGNATURES = {
    "cpe_smooth_wrapped": (3, 8, 0),
    "cpe_preprocess_binarize": (8, 13, 3),
    "cpe_connected_components": (3, 8, 0),
    "cpe_bridge_morphology": (6, 10, 0),
    "cpe_component_payload_minmax": (4, 8, 0),
    "cpe_connected_components_global": (4, 11, 0),
    "cpe_component_payload_minmax_global": (5, 11, 0),
    "cpe_bridge_morphology_global": (7, 7, 0),
    "cpe_bridge_morphology_split": (6, 10, 0),
    "cpe_solve_spd_factor": (4, 3, 0),
    "cpe_solve_spd_refine": (4, 3, 0),
    "cpe_stencil_smooth": (3, 7, 0),
    "cpe_stencil_stats": (10, 10, 1),
}

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
    for name, (n_ptr, n_int, n_float) in SIGNATURES.items():
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
    if SIGNATURES[name] != (len(tensors), len(ints), len(floats)):
        raise TypeError(f"{name} takes {SIGNATURES[name]} (pointers, ints, floats)")
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
