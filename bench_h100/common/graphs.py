"""Kernel nodes of a CUDA graph, counted during its capture through the
driver (``cuStreamGetCaptureInfo``, ``cuGraphGetNodes``,
``cuGraphNodeGetType``): the benchmark's own copy of the node count of the
port's ``utils/profiling.graph_kernels``."""

from __future__ import annotations

import ctypes

CU_STREAM_CAPTURE_ACTIVE = 1
CU_GRAPH_NODE_KERNEL = 0


def _call(cu, name: str, *args) -> None:
    rc = getattr(cu, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA driver error {rc}")


def count_kernels(kinds) -> int:
    """Kernel nodes among a graph's node types (copies and sets are other types)."""
    return sum(1 for k in kinds if k == CU_GRAPH_NODE_KERNEL)


def capture_node_kinds(cu, stream_handle: int) -> list:
    """The node types of the graph the stream is capturing, read before the
    capture ends."""
    stream = ctypes.c_void_p(stream_handle)
    status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, ndeps, size = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_size_t()
    _call(cu, "cuStreamGetCaptureInfo_v2", stream, ctypes.byref(status), ctypes.byref(cid),
          ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
    if status.value != CU_STREAM_CAPTURE_ACTIVE:
        raise RuntimeError("the stream is not capturing")
    _call(cu, "cuGraphGetNodes", graph, None, ctypes.byref(size))
    nodes = (ctypes.c_void_p * size.value)()
    _call(cu, "cuGraphGetNodes", graph, nodes, ctypes.byref(size))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int()
        _call(cu, "cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    return kinds


def graph_kernels(fn) -> int:
    """Kernel nodes of one ``fn()`` call captured as a CUDA graph on the
    current device (``fn`` warmed up by the caller); the graph is dropped."""
    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
        kinds = capture_node_kinds(cu, torch.cuda.current_stream().cuda_stream)
    del graph
    torch.cuda.synchronize()
    return count_kernels(kinds)
