"""A conv-serving bucket's launch on the card, compiled once: the port's
counterpart of `repro`'s `jax.jit` of each (bucket, rung)'s forward
(`repro/serve/conv_engine.py:237-243`, `_jitted`).

Eager PyTorch pays the host's dispatch for every op of every launch:
the generator's three transposed convs and their epilogues, the ASPP
head's three dilated branches and its 1x1 fuse, and the Python that
wraps each.  A `torch.cuda.CUDAGraph` records the bucket's forward at
its fixed slot batch once and each replay queues it with one launch.

Each `ConvGraph` holds, on the card, a fixed input buffer
(slot_batch, *payload_shape), pinned host staging buffers for the input
and the output, and the output in the graph's memory pool; the engine's
graphs share one pool (they replay one at a time, on one stream).  A
launch copies the host batch into the pinned input, then into the input
buffer, replays, copies the output to the pinned output and returns a
host copy of it.

A forward executes when eager but only records under capture, so the
first launch of a (bucket, rung) runs the forward eagerly, on the
capture stream, as the real launch whose result is served, and the
capture follows (`device.eager_then_capture`, as `DecodeGraph` makes
its graphs); the next launch is the first replay.  The kernel wrappers (and
`ops.LAUNCHES`) run only at the eager launch and the capture; the
capture records how many launches each wrapper made in it
(`launches`), and every replay adds those to `replay_launches`.  A
capture that fails raises: there is no eager fallback on the card.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable

import numpy as np
import torch

from repro_torch.device import eager_then_capture


class ConvGraph:
    """`fn(batch)` -- a (slot_batch, *payload_shape) fp32 batch on the
    card in, the output batch out -- as one graph in the memory pool
    `pool` (`torch.cuda.graph_pool_handle()`).  Calling it with a host
    batch returns the host output."""

    def __init__(self, fn: Callable, shape: tuple, device: torch.device,
                 pool):
        if device.type != "cuda":
            raise ValueError(f"a ConvGraph runs on a CUDA device, got "
                             f"{device}")
        self.fn, self.device, self.pool = fn, device, pool
        self.stream = torch.cuda.Stream(device)
        self.input = torch.zeros(shape, dtype=torch.float32, device=device)
        self.host_in = torch.zeros(shape, dtype=torch.float32).pin_memory()
        self.host_out = None
        self.graph = None
        self.output = None
        self.captures = 0
        self.launches = {}           # kernel -> launches in the capture
        self.replay_launches = Counter()   # kernel -> launches replayed

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        self.host_in.numpy()[...] = batch
        self.input.copy_(self.host_in, non_blocking=True)
        if self.graph is None:
            out = self._first()
        else:
            self.graph.replay()
            self.replay_launches.update(self.launches)
            out = self.output
        self.host_out.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self.host_out.numpy().copy()

    def _first(self) -> torch.Tensor:
        """The first launch, run eagerly on the capture stream, then the
        capture (which records and runs nothing).  Returns the eager
        output."""
        with torch.no_grad():
            out, self.graph, self.output, self.launches = eager_then_capture(
                lambda: self.fn(self.input), self.stream, self.pool)
        self.host_out = torch.empty(out.shape, dtype=out.dtype).pin_memory()
        self.captures += 1
        return out
