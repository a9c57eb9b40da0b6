"""The nodes of a captured CUDA graph: what the capture of some work
launched on the device, read from ``libcuda`` with ``ctypes``.

A capture records every operation the captured work enqueued as a node of
the graph, so a count read from it cannot lose a record, as a profiler
trace can (CUPTI delivers its activity records asynchronously, and a trace
may come back short).  The checks "one launch and no memset" and "N
launches of a kernel" read the nodes of a graph of the work, captured with
``torch.cuda.CUDAGraph(keep_graph=True)`` so that ``raw_cuda_graph()``
gives the ``cudaGraph_t`` (the same object as libcuda's ``CUgraph``).

Nothing here runs when the module is imported: ``libcuda`` is loaded on
the first call, on a machine with a card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

# CUgraphNodeType (cuda.h); the runtime's cudaGraphNodeType has the same
# values
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h): ``func`` is set for a
    context's function, ``kern`` for a library kernel."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    for fn in ("cuFuncGetName", "cuKernelGetName"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_void_p]
    for fn in ("cuGraphGetNodes", "cuGraphNodeGetType",
               "cuGraphKernelNodeGetParams_v2", "cuFuncGetName",
               "cuKernelGetName"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (libcuda)")


def _kernel_name(lib, node) -> str:
    p = _KernelNodeParams()
    _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
           "cuGraphKernelNodeGetParams")
    name = ctypes.c_char_p()
    if p.func:
        _check(lib.cuFuncGetName(ctypes.byref(name), p.func),
               "cuFuncGetName")
    else:
        _check(lib.cuKernelGetName(ctypes.byref(name), p.kern),
               "cuKernelGetName")
    return (name.value or b"").decode()


def graph_nodes(graph) -> List[Tuple[str, str]]:
    """``(type, kernel name or "")`` of every node of ``graph`` (a
    ``torch.cuda.CUDAGraph`` made with ``keep_graph=True`` and captured),
    in the order libcuda lists them."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        kind = NODE_TYPES.get(t.value, str(t.value))
        out.append((kind, _kernel_name(lib, node) if kind == "kernel"
                    else ""))
    return out


def capture_nodes(torch, fn):
    """Capture one call of ``fn()`` in a CUDA graph (on a side stream, as
    capture wants; the caller has run ``fn`` once eagerly, so that nothing
    it allocates or loads on a first call lands in the capture) and return
    ``(nodes, graph)``: its ``graph_nodes`` and the graph, which the caller
    may replay."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return graph_nodes(graph), graph
