"""Device resolution shared by the port's entry points, and the steps
every CUDA graph of the port is made by: an eager run on the graph's
stream, then the capture, under a guard, with its kernel launches
counted."""
from __future__ import annotations

import contextlib
import gc
from typing import Callable

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  A CUDA device with no card raises: the
    entry points never fall back to the CPU on their own -- a caller who
    wants the CPU says `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def on_stream(fn: Callable, stream: torch.cuda.Stream):
    """`fn()` queued on `stream`, after the work the caller's stream has
    queued and before the work it queues next."""
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        out = fn()
    caller.wait_stream(stream)
    return out


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, *, stream: torch.cuda.Stream,
            pool=None):
    """`torch.cuda.graph(graph, pool=pool, stream=stream)` with Python's
    cyclic garbage collector paused.  A collection during the capture may
    destroy another CUDA graph, or free its memory, held by a dead cycle
    (an engine and the graphs of its own launches): a CUDA call that a
    capture forbids, which invalidates it.  Whatever was dead before is
    collected after.  Yields a dict that holds, once the block ends, the
    launches each kernel wrapper of `kernels/ops.py` made in it: the
    capture's own count, which every replay makes again."""
    from repro_torch.kernels import ops

    launches: dict = {}
    before = dict(ops.LAUNCHES)
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            yield launches
    finally:
        if enabled:
            gc.enable()
    launches.update(ops.launches_since(before))


def eager_then_capture(fn: Callable, stream: torch.cuda.Stream, pool=None):
    """`fn()` run eagerly on `stream`, then captured there (`capture`):
    (the eager run's output, the graph, the capture's output, the
    capture's launches).  The eager run is the real call, whose output the
    caller uses; it also makes the kernels' one-time calls
    (`cudaFuncSetAttribute`, the buffers kept per stream, cuBLAS's and
    cuDNN's workspaces for the stream) outside the capture.  The capture
    records and runs nothing; a replay runs it.  A capture that fails
    raises."""
    out = on_stream(fn, stream)
    graph = torch.cuda.CUDAGraph()
    with capture(graph, pool=pool, stream=stream) as launches:
        captured = fn()
    return out, graph, captured, launches
