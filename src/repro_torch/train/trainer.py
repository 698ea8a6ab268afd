"""Trainer: the LM's train loop with checkpoint/restart, async saves,
deterministic data skip-ahead and a failure hook for tests (port of
`repro/train/trainer.py`), on one device.

  * data:        `data/pipeline.py::TokenDataset` batches are pure
    functions of (seed, step), so a resumed run replays bit-identical
    data; a `Prefetcher` thread draws them ahead, and its `put` hook moves
    each to pinned memory and copies it to the card with
    `non_blocking=True`.
  * the step:    `launch/steps.py::make_train_step` (AdamW), run eagerly:
    its gradients come from autograd through the hand-written attention
    kernels, forward and backward.  (Its capture as one CUDA graph, as
    `ConvTrainer`'s is, is ROADMAP A.17.)
  * checkpoints: `train/checkpoint.py`, `repro`'s on-disk format, so each
    package resumes the other's runs; `{"params", "opt"}` trees.
  * the loss is read to the host only at log steps, as `repro` does.

`device=None` means the card.  `repro`'s Trainer also takes a `mesh`;
the LM on a mesh (its param and cache layouts, `Trainer` and
`ServeEngine` with a mesh) is ROADMAP A.12's LM half, still to port.
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

from repro_torch.data.pipeline import Prefetcher, TokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import effective_microbatches, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.lm import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import StepGuard


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
                 tcfg: Optional[TrainerConfig] = None, *, device=None):
        self.cfg = cfg
        self.dataset = dataset
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        self.n_micro = effective_microbatches(cfg, dataset.global_batch)
        self._ckptr = (ckpt.AsyncCheckpointer(self.tcfg.ckpt_dir,
                                              self.tcfg.keep_last)
                       if self.tcfg.ckpt_dir else None)
        self.guard = StepGuard(step_timeout_s=self.tcfg.step_timeout_s)
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.n_micro)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """Fresh params drawn on the trainer's device from `seed` (on the
        card by a CUDA generator: no host draw), and AdamW's state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.lm.init(gen, device=self.device)
        return params, adamw_init(params, self.opt_cfg), 0

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
        state = ckpt.restore(d, step, self._like())
        return state["params"], state["opt"], step

    def save(self, step, params, opt, blocking=False):
        if not self._ckptr:
            return
        tree = {"params": params, "opt": opt}
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
        if self.device.type != "cuda":
            return out, None
        out = {k: t.pin_memory().to(self.device, non_blocking=True)
               for k, t in out.items()}
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return out, ready

    def _take(self, batches: Prefetcher) -> dict:
        """The next batch, ordered after its copy on the stream the step
        runs on, whichever that is."""
        batch, ready = next(batches)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    # -- loop ----------------------------------------------------------------
    def run(self, *, fail_at_step: Optional[int] = None) -> Dict[str, Any]:
        """Train to total_steps (resuming from the latest checkpoint).
        `fail_at_step` raises after that step completes -- used by the
        fault-tolerance tests to simulate a node failure."""
        params, opt, start = self.maybe_restore()
        history = []
        batches = Prefetcher(self.dataset, start_step=start, put=self._put)
        try:
            for step in range(start, self.tcfg.total_steps):
                batch = self._take(batches)   # deterministic skip-ahead
                self.guard.start_step()
                params, opt, metrics = self.step_fn(params, opt, batch)
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
        if self._ckptr:
            self.save(self.tcfg.total_steps, params, opt, blocking=True)
            self._ckptr.wait()
        return {"params": params, "opt": opt, "history": history}
