"""The trainer's step on the card as one CUDA graph, captured once and
replayed for every attempt: the port's counterpart of `repro`'s
`jax.jit` of the step (`repro/train/conv_trainer.py:133`).

Eager PyTorch pays the host's dispatch for every op of every step: the
GAN step queues ~83 kernels, and its device is idle most of the step.
A `torch.cuda.CUDAGraph` records the whole step once -- forward,
autograd's backward (the hand-written kernels' launches included), the
SGD update, the all-finite flag and the metrics -- and each replay
queues all of it with one launch.

The graph reads fixed input buffers and writes fixed output buffers:

  * inputs: the state tree (`state`), the batch tensors (`data`) and a
    0-d fp32 `lr` tensor, so a shrink-lr retry is a fill of `lr` and not
    a new graph;
  * outputs: whatever the step function returns (the new state, the
    metrics, the flag), in the graph's own memory pool.  The graph never
    writes its input state: a non-finite step is rolled back by not
    committing, as `repro` keeps its old (never donated) state.
    `commit` is one multi-tensor copy of the new state into the input
    buffers.

Capture happens at the first `run`, after `WARMUP_STEPS` eager steps on
the capture stream itself: they allocate what the kernels keep per
(device, stream) -- `kernels/dconv_backward.launch_buffers`' zeroed
ticket buffer -- and make each kernel's one-time
`cudaFuncSetAttribute` outside the capture.  Warm-up steps commit
nothing.  The Python wrappers of `kernels/ops.py` run only while the
step is traced (warm-up and capture), so `ops.LAUNCHES` counts
`WARMUP_STEPS + 1` steps however many replays follow; a replay's
launches are read from a profiler trace.  A capture that fails raises:
there is no eager fallback on the card.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map

WARMUP_STEPS = 2


def _same_shapes(bufs, new, what: str) -> None:
    if [(t.shape, t.dtype) for t in bufs] != \
            [(t.shape, t.dtype) for t in new]:
        raise ValueError(f"{what} does not match the captured step's "
                         f"buffers")


class StepGraph:
    """`step_fn(state, data, lr)` on one CUDA device as one graph.

    `load(state)` copies a state tree into the input buffers, `put(arrays)`
    copies host arrays into the batch buffers, `run(lr)` replays (and, the
    first time, captures) and returns the step's outputs, `commit(new)`
    copies a new state into the input buffers.  `captures` counts
    captures; it stays 1 for the object's life."""

    def __init__(self, step_fn: Callable, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a StepGraph runs on a CUDA device, got "
                             f"{device}")
        self.step_fn = step_fn
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.state = None
        self.data = None
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.graph = None
        self.outputs = None
        self.captures = 0

    def load(self, state) -> None:
        """Copy `state` (a tree of tensors) into the input state buffers,
        allocating them the first time."""
        if self.state is None:
            self.state = tree_map(lambda t: t.detach().to(self.device,
                                                          copy=True), state)
            return
        self.commit(state)

    def commit(self, new_state) -> None:
        """Copy `new_state` into the input state buffers: one multi-tensor
        copy on the current stream, ordered after the replay."""
        dst, src = tree_leaves(self.state), tree_leaves(new_state)
        _same_shapes(dst, src, "the state")
        torch._foreach_copy_(dst, src)

    def put(self, arrays: Sequence[np.ndarray]) -> tuple:
        """Copy host arrays into the batch buffers (allocated the first
        time) and return the buffers."""
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.data is None:
            self.data = tuple(torch.empty(h.shape, dtype=h.dtype,
                                          device=self.device) for h in host)
        _same_shapes(self.data, host, "the batch")
        for buf, h in zip(self.data, host):
            buf.copy_(h)
        return self.data

    def run(self, lr: float):
        """The step at learning rate `lr` on the loaded state and batch:
        the graph's output buffers, valid until the next `run`."""
        if self.state is None or self.data is None:
            raise RuntimeError("load a state and put a batch before run")
        self.lr.fill_(lr)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.outputs

    def _capture(self) -> None:
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self.step_fn(self.state, self.data, self.lr)
        caller.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            outputs = self.step_fn(self.state, self.data, self.lr)
        self.graph, self.outputs = graph, outputs
        self.captures += 1
