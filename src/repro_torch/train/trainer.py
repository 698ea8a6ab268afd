"""Trainer: the LM's train loop with checkpoint/restart, async saves,
deterministic data skip-ahead and a failure hook for tests (port of
`repro/train/trainer.py`), on one device.

  * data:        `data/pipeline.py::TokenDataset` batches are pure
    functions of (seed, step), so a resumed run replays bit-identical
    data; a `Prefetcher` thread draws them ahead, and its `put` hook moves
    each to pinned memory and copies it to the card with
    `non_blocking=True`.
  * the step:    `launch/steps.py::make_train_step` (AdamW): its
    gradients come from autograd through the hand-written attention
    kernels, forward and backward.  On a CUDA device with no mesh it runs
    as one CUDA graph per run (`train/step_graph.py`, the counterpart of
    `repro`'s `jax.jit` of the step with both trees donated): the state
    lives in fixed buffers, each batch is copied into the graph's batch
    buffers on the step's stream, and the step ends with one
    multi-tensor copy of the new state into the state buffers inside the
    graph (`committing_step`), so the graph needs no more memory than the
    eager step.  The first step runs eagerly on the graph's stream and is
    the real, committed step; the second captures the graph and replays
    it, and every later step is a replay.  A capture that fails raises.
    On the CPU and on a mesh the step runs eagerly (`gloo`'s collectives
    cannot be captured).
  * checkpoints: `train/checkpoint.py`, `repro`'s on-disk format, so each
    package resumes the other's runs; `{"params", "opt"}` trees.
  * the loss is read to the host only at log steps, as `repro` does;
    under the graph it is read from the graph's output before the next
    replay.  A checkpoint copies the state buffers to the host before it
    returns, and the trees `run` returns are the buffers, which the
    graph hands over (`StepGraph.release`): no later replay writes them.

`device=None` means the card.  With a `mesh` (a `DeviceMesh` of
`launch/mesh.py` or `fault_tolerance.elastic_mesh`; every family)
every rank of the mesh runs the same trainer: fresh params are drawn
whole on every rank from the seed and laid out by `tree_shardings`, the
optimizer state made from each rank's blocks in the same layout, each
batch laid out by `batch_pspec` by the prefetch thread (no
communication: each rank keeps its block), and the step is
`make_train_step`'s on the blocks.  Checkpoints hold whole leaves
(gathered over the mesh, written by its first rank), so `maybe_restore`
lays a checkpoint of any mesh -- or of one device, or of `repro` --
out on this one through `checkpoint.restore(..., shardings)`.
With an `embed_input` config (the audio and vlm families) the
`TokenDataset` yields (B, S, D) fp32 embeddings, which `_put` moves
through pinned memory like tokens.
The step accumulates over the config's microbatch count, clamped to the
batch (`effective_microbatches`); `repro`'s Trainer always jits one
microbatch, which a config with `microbatch=1` reproduces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import Prefetcher, TokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import effective_microbatches, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.lm import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import StepGuard
from repro_torch.train.step_graph import StepGraph

BATCH_KEYS = ("inputs", "labels")


def committing_step(step_fn):
    """`step(state, data) -> metrics`: the LM's `step_fn(params, opt,
    batch)` as its graph runs it, on the state buffers `state`
    ({"params", "opt"}) and the batch buffers `data` (BATCH_KEYS' order),
    ending with one multi-tensor copy of the new state into `state`'s
    tensors: `repro`'s donation of both trees, inside the graph."""
    def step(state, data):
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       dict(zip(BATCH_KEYS, data)))
        torch._foreach_copy_(tree_leaves(state),
                             tree_leaves({"params": params, "opt": opt}))
        return metrics
    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    # Fresh params are drawn by a generator on the trainer's device, so one
    # seed gives other weights on the card than on the CPU.
    seed: int = 0
    # fault tolerance
    step_timeout_s: Optional[float] = None   # straggler watchdog
    async_checkpoint: bool = True


class Trainer:
    def __init__(self, cfg: ModelConfig, dataset: TokenDataset,
                 opt_cfg: Optional[AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None, *, mesh=None,
                 device=None):
        self.cfg = cfg
        self.dataset = dataset
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.lm = LM(cfg)
        self.n_micro = effective_microbatches(cfg, dataset.global_batch,
                                              mesh)
        self._ckptr = (ckpt.AsyncCheckpointer(self.tcfg.ckpt_dir,
                                              self.tcfg.keep_last)
                       if self.tcfg.ckpt_dir and mesh is None else None)
        if mesh is not None:
            like = self._like()
            self.p_sh = sh.tree_shardings(like["params"], mesh)
            self.o_sh = sh.tree_shardings(like["opt"], mesh)
        self.guard = StepGuard(step_timeout_s=self.tcfg.step_timeout_s)
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.n_micro)
        # The compiled step on the card: captured at each run's second step.
        self.graph = (StepGraph(committing_step(self.step_fn), self.device,
                                lr=False, eager_first=True)
                      if self.device.type == "cuda" and mesh is None
                      else None)

    @property
    def captures(self) -> int:
        """CUDA-graph captures of this trainer's step (0 on the CPU)."""
        return 0 if self.graph is None else self.graph.captures

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """Fresh params drawn on the trainer's device from `seed` (on the
        card by a CUDA generator: no host draw), and AdamW's state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.lm.init(gen, device=self.device)
        if self.mesh is None:
            return params, adamw_init(params, self.opt_cfg), 0
        params = sh.device_put(params, self.p_sh)
        blocks = tree_map(lambda t: sh.as_sharded(t, self.mesh).local,
                          params)
        opt = tree_map(lambda t, ns: sh.from_local(t, self.mesh, ns.spec),
                       adamw_init(blocks, self.opt_cfg), self.o_sh)
        return params, opt, 0

    def _like(self):
        """The state's structure, shapes, dtypes and device, allocating
        nothing: what `checkpoint.restore` reads from `like`."""
        with torch.device("meta"):
            params = self.lm.init_tree(torch.Generator())
            opt = adamw_init(params, self.opt_cfg)
        return tree_map(lambda t: torch.empty((), dtype=t.dtype,
                                              device=self.device)
                        .expand(t.shape), {"params": params, "opt": opt})

    def maybe_restore(self):
        """The latest intact checkpoint's (params, opt, step), or a fresh
        state at step 0."""
        d = self.tcfg.ckpt_dir
        step = ckpt.latest_step(d) if d else None
        if step is None:
            return self.init_state()
        shardings = None if self.mesh is None else \
            {"params": self.p_sh, "opt": self.o_sh}
        state = ckpt.restore(d, step, self._like(), shardings)
        return state["params"], state["opt"], step

    def save(self, step, params, opt, blocking=False):
        tree = {"params": params, "opt": opt}
        if self.mesh is not None and self.tcfg.ckpt_dir:
            # Whole leaves: every rank takes part in the gathers, the
            # first writes, and none goes on before the step is published.
            whole = tree_map(sh.full_tensor, tree)
            if dist.get_rank() == int(self.mesh.mesh.flatten()[0]):
                ckpt.save(self.tcfg.ckpt_dir, step, whole,
                          keep_last=self.tcfg.keep_last)
            sh.barrier(self.mesh)
            return
        if not self._ckptr:
            return
        if self.tcfg.async_checkpoint and not blocking:
            self._ckptr.save_async(step, tree)
        else:
            self._ckptr.wait()   # no async write of the same step in flight
            ckpt.save(self.tcfg.ckpt_dir, step, tree,
                      keep_last=self.tcfg.keep_last)

    def _put(self, batch: dict):
        """(a numpy batch as tensors on the device, the event its copy
        ends at or None): on the card through pinned memory, the copy
        queued on this (the prefetch) thread's stream without waiting."""
        out = {k: torch.from_numpy(a) for k, a in batch.items()}
        ready = None
        if self.device.type == "cuda":
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in out.items()}
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        if self.mesh is not None:     # this rank's block; no communication
            out = {k: sh.device_put(t, sh.NamedSharding(
                self.mesh, sh.batch_pspec(self.mesh, t.dim(), 0,
                                          t.shape[0])))
                   for k, t in out.items()}
        return out, ready

    def _take(self, batches: Prefetcher) -> dict:
        """The next batch, ordered after its copy on the stream the step
        runs on, whichever that is."""
        batch, ready = next(batches)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                if self.mesh is not None:
                    t = sh.as_sharded(t, self.mesh).local
                t.record_stream(stream)
        return batch

    # -- loop ----------------------------------------------------------------
    def run(self, *, fail_at_step: Optional[int] = None) -> Dict[str, Any]:
        """Train to total_steps (resuming from the latest checkpoint).
        `fail_at_step` raises after that step completes -- used by the
        fault-tolerance tests to simulate a node failure."""
        params, opt, start = self.maybe_restore()
        graph = self.graph
        if graph is not None:
            graph.load({"params": params, "opt": opt})
            params, opt = graph.state["params"], graph.state["opt"]
        history = []
        batches = Prefetcher(self.dataset, start_step=start, put=self._put)
        try:
            for step in range(start, self.tcfg.total_steps):
                batch = self._take(batches)   # deterministic skip-ahead
                self.guard.start_step()
                if graph is not None:
                    graph.put([batch[k] for k in BATCH_KEYS])
                    metrics = graph.run()
                else:
                    with sh.use_mesh(self.mesh):
                        params, opt, metrics = self.step_fn(params, opt,
                                                            batch)
                if self.guard.straggled():
                    # Straggler watchdog: surface, checkpoint, continue.
                    self.save(step + 1, params, opt, blocking=True)
                if (step + 1) % self.tcfg.log_every == 0 or \
                        step + 1 == self.tcfg.total_steps:
                    history.append({"step": step + 1,
                                    "loss": float(metrics["loss"])})
                if self.tcfg.ckpt_dir and \
                        (step + 1) % self.tcfg.ckpt_every == 0:
                    self.save(step + 1, params, opt)
                if fail_at_step is not None and step + 1 >= fail_at_step:
                    if self._ckptr:
                        self._ckptr.wait()
                    raise RuntimeError(
                        f"injected failure at step {step + 1}")
        finally:
            batches.close()
        if self.tcfg.ckpt_dir:
            self.save(self.tcfg.total_steps, params, opt, blocking=True)
        if self._ckptr:
            self._ckptr.wait()
        if graph is not None:   # the buffers are the caller's from here
            graph.release()
        return {"params": params, "opt": opt, "history": history}
