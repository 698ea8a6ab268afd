"""A training step on the card as one CUDA graph, captured once and
replayed for every later step: the port's counterpart of `repro`'s
`jax.jit` of the step (`repro/train/conv_trainer.py:133` for
`ConvTrainer`, `repro/train/trainer.py:71` for the LM's `Trainer`).

Eager PyTorch pays the host's dispatch for every op of every step: the
GAN step queues ~83 kernels, the LM's thousands, and the device idles
while the host queues them.  A `torch.cuda.CUDAGraph` records the whole
step once -- forward, autograd's backward (the hand-written kernels'
launches included), the optimizer's update and the metrics -- and each
replay queues all of it with one launch.

The graph reads fixed input buffers and writes fixed output buffers:

  * inputs: the state tree (`state`), the batch tensors (`data`) and,
    for a step that takes one (`lr=True`), a 0-d fp32 `lr` tensor, so a
    shrink-lr retry is a fill of `lr` and not a new graph;
  * outputs: whatever the step function returns, in the graph's own
    memory pool.  `ConvTrainer`'s step returns the new state, the
    metrics and the all-finite flag and never writes its input state: a
    non-finite step is rolled back by not committing, as `repro` keeps
    its old (never donated) state, and `commit` is one multi-tensor copy
    of a finite step's state into the input buffers.  The LM's step
    (`train/trainer.py::committing_step`) returns only its metrics and
    ends with that copy itself, inside the graph, as `repro` donates
    both trees.

Two ways to reach the capture:

  * `eager_first=False` (`ConvTrainer`): the first `run` makes
    `WARMUP_STEPS` eager steps on the capture stream, which commit
    nothing, then captures and replays;
  * `eager_first=True` (the LM): the first `run` empties the
    allocator's cache, then makes one eager step on the capture stream,
    the real step whose result is used; the second `run` captures and
    replays, with no warm-up.

Either way the eager steps make what the kernels keep per (device,
stream) -- `kernels/dconv_backward.launch_buffers`' zeroed ticket
buffer, cuBLAS's workspace -- and each kernel's one-time
`cudaFuncSetAttribute` outside the capture.  The Python wrappers of
`kernels/ops.py` run only while the step is traced (eager steps and the
capture), so `ops.LAUNCHES` counts those; the capture records how many
launches each wrapper made in it (`launches`), and every replay adds
those to `replay_launches` (a replay calls no wrapper: a profiler trace
shows its kernels).  A capture that fails -- an op that reads a device
value back to the host, say -- raises: there is no eager fallback on
the card.  `release` hands the state buffers to the caller and drops
the graph; a later `load` and `run` capture anew.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import capture, on_stream
from repro_torch.models.layers import tree_leaves, tree_map

WARMUP_STEPS = 2


def _same_shapes(bufs, new, what: str) -> None:
    if [(t.shape, t.dtype) for t in bufs] != \
            [(t.shape, t.dtype) for t in new]:
        raise ValueError(f"{what} does not match the captured step's "
                         f"buffers")


class StepGraph:
    """`step_fn(state, data, lr)` -- or `step_fn(state, data)` with
    `lr=False` -- on one CUDA device as one graph.

    `load(state)` takes a state tree over as the input buffers (later
    loads copy into them), `put(arrays)`
    copies host arrays or device tensors into the batch buffers, `run(lr)`
    runs the step (eagerly, or by a replay that the first replay's call
    captures) and returns its outputs, `commit(new)` copies a new state
    into the input buffers.  `captures` counts captures: one for each
    `load` after a `release`."""

    def __init__(self, step_fn: Callable, device: torch.device, *,
                 lr: bool = True, eager_first: bool = False):
        if device.type != "cuda":
            raise ValueError(f"a StepGraph runs on a CUDA device, got "
                             f"{device}")
        self.step_fn = step_fn
        self.device = device
        self.takes_lr = lr
        self.eager_first = eager_first
        self.stream = torch.cuda.Stream(device)
        self.state = None
        self.data = None
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.graph = None
        self.outputs = None
        self.captures = 0
        self.launches = {}           # kernel -> launches in the capture
        self.replay_launches = Counter()   # kernel -> launches replayed
        self._eager_done = False

    def load(self, state) -> None:
        """Take `state` (a tree of tensors on the graph's device) over as
        the input state buffers the first time, with no copy: the caller
        hands it over and holds no second copy of the state; later, copy
        `state` into the buffers."""
        if self.state is None:
            self.state = tree_map(lambda t: t.detach().to(self.device), state)
            return
        self.commit(state)

    def commit(self, new_state) -> None:
        """Copy `new_state` into the input state buffers: one multi-tensor
        copy on the current stream, ordered after the replay."""
        dst, src = tree_leaves(self.state), tree_leaves(new_state)
        _same_shapes(dst, src, "the state")
        torch._foreach_copy_(dst, src)

    def put(self, arrays: Sequence) -> tuple:
        """Copy host arrays, or tensors, into the batch buffers (allocated
        the first time) on the current stream, and return the buffers."""
        src = [a if isinstance(a, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.data is None:
            self.data = tuple(torch.empty(t.shape, dtype=t.dtype,
                                          device=self.device) for t in src)
        _same_shapes(self.data, src, "the batch")
        for buf, t in zip(self.data, src):
            buf.copy_(t)
        return self.data

    def run(self, lr: float = None):
        """The step (at learning rate `lr`, for a step that takes one) on
        the loaded state and batch: the eager first step's outputs, or
        the graph's output buffers, valid until the next `run`."""
        if self.state is None or self.data is None:
            raise RuntimeError("load a state and put a batch before run")
        if self.takes_lr:
            self.lr.fill_(lr)
        if self.graph is None:
            if self.eager_first and not self._eager_done:
                self._eager_done = True
                return self._eager()
            self._capture()
        self.graph.replay()
        self.replay_launches.update(self.launches)
        return self.outputs

    def release(self) -> None:
        """Drop the graph, its memory pool and the buffers: the state
        buffers the caller holds are written by no later replay."""
        self.state = self.data = self.graph = self.outputs = None
        self._eager_done = False

    def _call(self):
        args = (self.state, self.data) + ((self.lr,) if self.takes_lr else ())
        return self.step_fn(*args)

    def _eager(self):
        """The first step, run eagerly on the capture stream.  The
        allocator's cache is emptied first: the blocks freed on other
        streams (what drawing the state left, on the caller's) cannot be
        reused on this one and would sit beside the step's own, as
        `torch.cuda.graph` empties it before the capture."""
        torch.cuda.empty_cache()
        return on_stream(self._call, self.stream)

    def _capture(self) -> None:
        # `torch.cuda.graph` empties the allocator's cache as it opens:
        # the eager steps' freed blocks are released to the device for the
        # graph's pool.
        if not self.eager_first:
            def warm_up():
                for _ in range(WARMUP_STEPS):
                    self._call()
            on_stream(warm_up, self.stream)
        graph = torch.cuda.CUDAGraph()
        with capture(graph, stream=self.stream) as launches:
            outputs = self._call()
        self.launches = launches
        self.graph, self.outputs = graph, outputs
        self.captures += 1
