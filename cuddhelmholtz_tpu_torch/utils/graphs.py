"""CUDA-graph capture of the port's replayed units: the DDH transfer apply
(``solvers/ddh.py::_ApplyGraph``) and the GMRES Arnoldi/Givens step
(``solvers/gmres.py::_StepGraphs``).  Each caller keeps its own static
inputs and outputs and its own cache of graphs; this module only captures."""

from __future__ import annotations

from typing import Callable

import torch

# eager calls of a unit before its capture.  One runs every kernel of the
# unit once on the capture stream, and with it all the lazy set-up a
# capture must not do (cuBLAS's handle and workspace for the stream, the
# loading of each kernel, the allocator's blocks); the units are fixed
# sequences of kernels, so a second call sets up nothing more.
WARMUP = 1


def capture(fn: Callable, args: tuple, pool, *, in_place: bool = False):
    """Capture ``fn(*args)`` as a CUDA graph into the memory pool ``pool``;
    returns (graph, the captured call's output, which every replay
    rewrites).

    ``fn`` runs WARMUP times first, eagerly, on copies of the tensors of
    ``args`` where it updates them in place (``in_place``).  Warm-up and
    capture run on torch's one capture stream (``torch.cuda.graph``'s),
    the same for every capture in the process: cuBLAS keeps a 32 MiB
    workspace for each stream it has run on, so a new stream per capture
    would hold 32 MiB more each time.  Unlike ``torch.cuda.graph`` it does
    not synchronise the device or empty the allocator's cache per capture.
    """
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.graph(graph, pool=pool).capture_stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(WARMUP):
            fn(*(a.clone() if in_place and isinstance(a, torch.Tensor) else a for a in args))
        graph.capture_begin(pool)
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out
