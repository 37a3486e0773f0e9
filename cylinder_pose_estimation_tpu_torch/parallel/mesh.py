"""The frame mesh: one process per device, the frame axis split over them
(the JAX package's parallel/mesh.py on ``torch.distributed``).

The JAX package drives every chip from one controller and lets XLA place
each frame block.  Here each rank is a process that owns one device, and
its host thread issues that device's launches: the kernel branch's detect
step is bound by the host that issues its ~1,600 launches, so ranks that
shared one process would serialise on the interpreter lock.  Frames are
data-parallel, as in the JAX package: each rank takes a contiguous block of
``n / size`` frames, detection and the per-frame fit need no communication,
one all-gather (``gather_frames``) gives every rank the whole per-frame
result, and the multi-frame registration is solved replicated on every
rank.

The caller chooses the backend; nothing falls back to another: NCCL where
each rank owns its card, gloo for CPU tensors, and gloo for the check mode
in which several ranks share one card (what the JAX dry run's virtual CPU
devices are to a TPU mesh).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

FRAME_AXIS = "frames"
# Collective and initialisation timeout of the groups this package starts:
# a rank whose peer died fails within it instead of waiting forever.
TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("nccl", "gloo")
# What torchrun sets for each rank.
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """A 1-D mesh over the frame axis, seen from one rank: the process
    group (None: the default group), this process's rank in it, the number
    of ranks (the JAX ``Mesh.size``) and the device this rank computes on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def _check_device(device: torch.device, backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"frame mesh backend {backend!r}: one of {BACKENDS}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"frame mesh device {device}: no CUDA device is available")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device on every rank, not {device}")


def make_mesh(
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> FrameMesh:
    """This process's FrameMesh.

    It joins ``group``; else the default group, if one is initialised; else
    it initialises the one that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) with
    ``backend`` (default: NCCL for a CUDA device, gloo for the CPU) and a
    timeout of ``TIMEOUT``.  With neither a group nor that environment it
    raises RuntimeError.

    ``devices``: one device per rank, indexed by rank (several ranks may
    name one card only under gloo); by default rank r computes on
    ``cuda:LOCAL_RANK``.  A CUDA device is made the current device before
    anything else touches CUDA, so no rank opens a context on another card.
    ``backend`` given with a group that runs another backend raises."""
    joining = group is not None or dist.is_initialized()
    if joining:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError("make_mesh: no process group is initialised and the environment does "
                               f"not describe one (missing {', '.join(missing)}); start the ranks with "
                               "torchrun or initialise torch.distributed first")
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if devices is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        if len(devices) != size:
            raise ValueError(f"make_mesh: {len(devices)} devices for {size} ranks")
        device = torch.device(devices[rank])
    if joining:
        got = dist.get_backend(group)
        if backend is not None and backend != got:
            raise ValueError(f"make_mesh: the group runs {got}, not {backend}")
        backend = got
    elif backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    _check_device(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not joining:
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("make_mesh: this PyTorch has no NCCL")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                timeout=TIMEOUT, **kw)
    return FrameMesh(group, rank, size, device)


def frame_slice(mesh: FrameMesh, n: int) -> tuple:
    """This rank's block ``[start, stop)`` of ``n`` frames (what the JAX
    package's ``frame_sharding`` gives each device); ``n`` must be divisible
    by the mesh size, as there."""
    if n % mesh.size:
        raise ValueError(f"{n} frames do not split over {mesh.size} ranks: the frame count must be "
                         "divisible by the mesh size")
    block = n // mesh.size
    return mesh.rank * block, (mesh.rank + 1) * block


def replicated(tree):
    """A value every rank holds whole (the JAX package's replicated
    sharding).  Each rank computes it from the same gathered inputs, so it
    is replicated by construction and nothing moves."""
    return tree


def _flatten(tree, path=""):
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        return [x for name, leaf in zip(names, tree) for x in _flatten(leaf, f"{path}.{name}")]
    return [(path.lstrip("."), tree)]


def _rebuild(tree, leaves):
    if isinstance(tree, tuple):
        return type(tree)(*[_rebuild(leaf, leaves) for leaf in tree])
    return next(leaves)


def gather_frames(tree, mesh: FrameMesh):
    """All-gather, in rank order, of a NamedTuple tree whose tensor leaves
    all lead with this rank's block of frames (the same count on every
    rank): every rank gets the tree of all ranks' frames, equal to the
    ranks' blocks concatenated, on its device.  ``None`` leaves stay None;
    any other leaf that is not a tensor with that frame axis raises
    ValueError.

    One collective: the leaves travel as one byte buffer (on the rank's
    device under NCCL, on the host under gloo), so bool, integer and float
    leaves all arrive bit for bit."""
    flat = _flatten(tree)
    tensors = [(p, x) for p, x in flat if x is not None]
    if not tensors:
        return tree
    first = tensors[0][1]
    n = first.shape[0] if isinstance(first, torch.Tensor) and first.dim() else None
    for path, x in tensors:
        if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != n:
            raise ValueError(f"gather_frames: leaf {path or '<root>'} is not a tensor with a leading "
                             f"frame axis of {n} (got {type(x).__name__} "
                             f"{tuple(x.shape) if isinstance(x, torch.Tensor) else ''})")
    comm = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    parts = [x.contiguous().reshape(-1).view(torch.uint8) for _, x in tensors]
    buf = torch.cat([p.to(mesh.device) for p in parts]).to(comm)
    out = torch.empty((mesh.size, buf.numel()), dtype=torch.uint8, device=comm)
    dist.all_gather(list(out.unbind(0)), buf, group=mesh.group)
    out = out.to(mesh.device)
    gathered, off = [], 0
    for (_, x), p in zip(tensors, parts):
        block = out[:, off:off + p.numel()].reshape(-1).clone().view(x.dtype)
        gathered.append(block.reshape((mesh.size * n,) + tuple(x.shape[1:])))
        off += p.numel()
    it = iter(gathered)
    return _rebuild(tree, (None if x is None else next(it) for _, x in flat))
