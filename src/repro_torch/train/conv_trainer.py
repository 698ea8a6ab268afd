"""ConvTrainer: the paper's CNN-classification and GAN workloads as
guarded, checkpointed training runs on one device or on a mesh of ranks
(port of `repro/train/conv_trainer.py`).

  * checkpoint/resume on the atomic `train/checkpoint.py` format (the
    same files as `repro`'s) with deterministic data skip-ahead:
    `data/pipeline.py::ConvDataset` batches are pure functions of (seed,
    step), so an interrupted run resumes bit for bit;
  * the numerics guard: each step also returns a 0-d all-finite flag
    over the updated params and the loss (`models/layers.py::
    tree_all_finite`), left on the device; the loop reads it and the
    losses in ONE device-to-host copy per attempt;
  * the non-finite policy of the shared `StepGuard`: rollback to the
    last good state (steps never write their input state, so rollback is
    not committing), per-layer blame localized EAGERLY on the CPU's
    `reference` backend on the failure path only, then bounded retry /
    skip / shrink-lr before giving up;
  * seeded fault consultation: one `serve.faults.FaultInjector` site
    (`train.<workload>`) is stepped once per step ATTEMPT -- launch-class
    events raise / delay, output-class events poison the host batch so
    the real guard trips.

On a CUDA device with no mesh the step runs as one CUDA graph, captured
once per trainer and replayed for every attempt (`train/step_graph.py`,
the counterpart of `repro`'s `jax.jit`); `lr` is a device tensor, so a
shrink-lr retry reuses the graph.  On the CPU the step function runs
eagerly.  `build_step` gives the eager step on either device.

With a `mesh` (a `DeviceMesh` of `launch/mesh.py` or
`fault_tolerance.elastic_mesh`) every rank of the mesh runs the same
trainer: the state is laid out by `parallel.sharding.tree_pspecs`, each
batch by `batch_pspec`, and the model steps run under `use_mesh`, so
every conv runs per shard.  That step runs EAGERLY: the collectives of a
process group such as `gloo` cannot be captured in a CUDA graph.
Checkpoints hold whole leaves (gathered, then written synchronously by
the mesh's first rank; `async_checkpoint` applies with no mesh), so
`maybe_restore` re-shards a checkpoint written on any mesh onto this
one.  `train/supervisor.py::RunSupervisor` restarts a run on the
surviving ranks by itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.data.pipeline import ConvDataset
from repro_torch.device import resolve_device
from repro_torch.models import cnn, gan
from repro_torch.models.layers import sgd_grads, tree_map, tree_paths
from repro_torch.parallel import sharding as sh
from repro_torch.serve import faults
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import StepGuard
from repro_torch.train.step_graph import StepGraph

WORKLOADS = ("cnn", "gan", "gan_gen")


class NonFiniteStepError(RuntimeError):
    """The bounded non-finite retry policy gave up: the step produced
    non-finite updates `max_retries`+ times in a row, which means the
    loss surface (or a kernel) is broken -- retrying further would hide
    a real bug.  Carries the per-layer blame."""

    def __init__(self, step: int, blame: Sequence[str]):
        super().__init__(
            f"step {step} non-finite after bounded retries; "
            f"non-finite grads in: {list(blame)}")
        self.step = step
        self.blame = tuple(blame)


@dataclasses.dataclass
class ConvTrainerConfig:
    workload: str = "cnn"            # cnn | gan | gan_gen
    total_steps: int = 8
    lr: float = 0.05
    backend: Optional[str] = None    # reference | torch_zero_free | cuda
    fuse_epilogue: bool = True
    stride: int = 2                  # CNN downsampling stride
    # model geometry
    widths: Sequence[int] = (8, 16)
    image: int = 12
    channels: int = 3
    n_classes: int = 10
    z_dim: int = 16
    base: int = 8
    batch: int = 8
    seed: int = 0
    # checkpointing
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 4
    keep_last: int = 3
    async_checkpoint: bool = False
    # guard / fault policy
    guard: bool = True
    step_timeout_s: Optional[float] = None
    max_retries: int = 2
    nonfinite_policy: str = "skip"   # skip | shrink_lr
    lr_shrink: float = 0.5
    blame: bool = True               # eager per-layer localization

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"workload must be one of {WORKLOADS}, "
                             f"got {self.workload!r}")


_BATCH_KEYS = {"cnn": ("x", "labels"), "gan": ("z", "real"),
               "gan_gen": ("z",)}


def _summary(metrics: Dict[str, torch.Tensor],
             finite: torch.Tensor) -> torch.Tensor:
    """[finite, *metrics] as one fp32 vector on the step's device, so
    the loop reads the flag and the losses in one copy."""
    return torch.stack([finite.to(torch.float32)]
                       + [v.to(torch.float32) for v in metrics.values()])


class ConvTrainer:
    """One conv training run on one device, or on one (fixed) mesh: mesh
    changes are a new trainer on the elastic mesh, restored from the
    checkpoint.  `device=None` means the card."""

    def __init__(self, tcfg: ConvTrainerConfig, *, mesh=None,
                 injector: Optional["faults.FaultInjector"] = None,
                 device=None):
        self.tcfg = tcfg
        self.mesh = mesh
        self.injector = injector
        self.device = resolve_device(device)
        self.data = ConvDataset(
            kind=tcfg.workload, batch=tcfg.batch, image=tcfg.image,
            channels=tcfg.channels, n_classes=tcfg.n_classes,
            z_dim=tcfg.z_dim, seed=tcfg.seed)
        self.guard = StepGuard(
            step_timeout_s=tcfg.step_timeout_s,
            max_retries=tcfg.max_retries,
            nonfinite_policy=tcfg.nonfinite_policy,
            lr_shrink=tcfg.lr_shrink)
        self._ckptr = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir,
                                              tcfg.keep_last)
                       if tcfg.ckpt_dir and tcfg.async_checkpoint
                       and mesh is None else None)
        self._site = faults.train_site(tcfg.workload)
        step = self.build_step(guarded=tcfg.guard)

        def packed(state, data, lr):
            new, metrics, finite = step(state, data, lr)
            return new, metrics, _summary(metrics, finite)

        self._step = packed
        # The compiled step on the card: captured at the first attempt.
        self.graph = (StepGraph(packed, self.device)
                      if self.device.type == "cuda" and mesh is None
                      else None)
        self.blames: List[Dict[str, Any]] = []
        # Monotonic time of this trainer's first COMPLETED step (capture
        # and restore included).
        self.first_step_wall: Optional[float] = None

    @property
    def captures(self) -> int:
        """CUDA-graph captures of this trainer's step (0 on the CPU)."""
        return 0 if self.graph is None else self.graph.captures

    # -- step construction ---------------------------------------------------
    def build_step(self, *, guarded: bool) -> Callable:
        """`(state, data_tuple, lr) -> (new_state, metrics, finite)` for
        this workload, run eagerly.  `lr` may be a 0-d tensor on the
        state's device.  With `guarded=False` the finite flag is a
        constant True and the body is exactly the unguarded model
        step."""
        t = self.tcfg
        be, fe = t.backend, t.fuse_epilogue

        def true_like(loss):
            return torch.ones((), dtype=torch.bool, device=loss.device)

        if t.workload == "cnn":
            def fn(state, data, lr):
                x, labels = data
                if guarded:
                    new, loss, fin = cnn.guarded_sgd_step(
                        state, x, labels, lr=lr, stride=t.stride,
                        backend=be, fuse_epilogue=fe)
                else:
                    new, loss = cnn.sgd_step(
                        state, x, labels, lr=lr, stride=t.stride,
                        backend=be, fuse_epilogue=fe)
                    fin = true_like(loss)
                return new, {"loss": loss}, fin
        elif t.workload == "gan_gen":
            def fn(state, data, lr):
                (z,) = data
                if guarded:
                    new_g, loss, fin = gan.guarded_gen_sgd_step(
                        state["g"], state["d"], z, lr=lr, backend=be,
                        fuse_epilogue=fe)
                else:
                    new_g, loss = gan.gen_sgd_step(
                        state["g"], state["d"], z, lr=lr, backend=be,
                        fuse_epilogue=fe)
                    fin = true_like(loss)
                return ({"g": new_g, "d": state["d"]}, {"loss": loss},
                        fin)
        else:   # gan: simultaneous G+D step on the {"g","d"} tree
            def fn(state, data, lr):
                z, real = data
                if guarded:
                    new, g_loss, d_loss, fin = gan.guarded_gan_sgd_step(
                        state, z, real, lr=lr, backend=be,
                        fuse_epilogue=fe)
                else:
                    new, g_loss, d_loss = gan.gan_sgd_step(
                        state, z, real, lr=lr, backend=be,
                        fuse_epilogue=fe)
                    fin = true_like(g_loss)
                return new, {"loss": g_loss, "d_loss": d_loss}, fin
        return fn

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """Seeded params on this trainer's device, drawn on the CPU from
        `torch.Generator().manual_seed(seed)` (other numbers than
        `repro`'s `PRNGKey` init)."""
        t = self.tcfg
        gen = torch.Generator().manual_seed(t.seed)
        if t.workload == "cnn":
            state = cnn.simple_cnn_init(
                gen, in_ch=t.channels, widths=tuple(t.widths),
                n_classes=t.n_classes, device=self.device)
        else:
            state = gan.gan_init(gen, z_dim=t.z_dim, base=t.base,
                                 ch=t.channels, device=self.device)
        if self.mesh is not None:
            state = sh.device_put(state, sh.tree_shardings(state,
                                                           self.mesh))
        return state

    def maybe_restore(self) -> Tuple[Any, int]:
        """(state, start_step): the latest INTACT checkpoint on this
        trainer's device (torn steps fall back with a RuntimeWarning
        inside `checkpoint.latest_step`/`restore`), or the seeded init at
        step 0."""
        state = self.init_state()
        d = self.tcfg.ckpt_dir
        if not d:
            return state, 0
        step = ckpt.latest_step(d)
        if step is None:
            return state, 0
        shardings = None if self.mesh is None else \
            sh.tree_shardings(state, self.mesh)
        return ckpt.restore(d, step, state, shardings), step

    def save(self, step: int, state, *, blocking: bool = False):
        if not self.tcfg.ckpt_dir:
            return
        if self.mesh is not None:
            # Whole leaves: every rank of the mesh takes part in the
            # gathers, the first writes, and none goes on before the
            # step is published.
            whole = tree_map(sh.full_tensor, state)
            if dist.get_rank() == int(self.mesh.mesh.flatten()[0]):
                ckpt.save(self.tcfg.ckpt_dir, step, whole,
                          keep_last=self.tcfg.keep_last)
            sh.barrier(self.mesh)
            return
        if self._ckptr is not None and not blocking:
            self._ckptr.save_async(step, state)
        else:
            if self._ckptr is not None:
                self._ckptr.wait()
            ckpt.save(self.tcfg.ckpt_dir, step, state,
                      keep_last=self.tcfg.keep_last)

    # -- data placement ------------------------------------------------------
    def _put_batch(self, batch: Dict[str, np.ndarray]) -> tuple:
        """The step's batch tensors: on the card, a host-to-device copy
        into the compiled step's input buffers; on the CPU, the arrays
        themselves."""
        arrs = [np.asarray(batch[k])
                for k in _BATCH_KEYS[self.tcfg.workload]]
        if self.graph is not None:
            return self.graph.put(arrs)
        if self.mesh is not None:
            return tuple(sh.device_put(
                torch.from_numpy(a).to(self.device), sh.NamedSharding(
                    self.mesh, sh.batch_pspec(self.mesh, a.ndim, 0,
                                              a.shape[0]))) for a in arrs)
        return tuple(torch.from_numpy(a) for a in arrs)

    # -- blame localization (failure path only) ------------------------------
    def localize_nonfinite(self, state, batch) -> List[str]:
        """Which layer's grad went non-finite: recompute the gradients
        EAGERLY on the CPU's `reference` backend from host copies and
        name the offending leaves, as `jax.tree_util.keystr` names them
        (e.g. "['convs'][0]").  This runs only after the guard tripped,
        so its cost is off the hot path."""
        t = self.tcfg
        host = tree_map(lambda a: sh.full_tensor(a).detach().to(
            "cpu", copy=True), state)
        ref = dict(backend="reference", fuse_epilogue=False)

        if t.workload == "cnn":
            x = torch.from_numpy(np.asarray(batch["x"]))
            labels = torch.from_numpy(np.asarray(batch["labels"]))
            _, grads = sgd_grads(lambda p: cnn.cnn_loss(
                p, x, labels, stride=t.stride, **ref), host)
        elif t.workload == "gan_gen":
            z = torch.from_numpy(np.asarray(batch["z"]))

            def g_loss(gp):
                fake = gan.generator_apply(gp, z, **ref)
                d_fake = gan.discriminator_apply(host["d"], fake, **ref)
                return F.softplus(-d_fake).mean()

            grads = {"g": sgd_grads(g_loss, host["g"])[1]}
        else:
            z = torch.from_numpy(np.asarray(batch["z"]))
            real = torch.from_numpy(np.asarray(batch["real"]))

            def both(st):
                g_loss, d_loss = gan.gan_losses(st["g"], st["d"], z, real,
                                                **ref)
                return g_loss + d_loss

            _, grads = sgd_grads(both, host)

        return sorted(path for path, leaf in tree_paths(grads)
                      if not bool(torch.isfinite(leaf).all()))

    # -- loop ----------------------------------------------------------------
    def _attempt(self, state, data, lr: float):
        """One step attempt: (new_state, host metrics, finite).  The flag
        and the losses come to the host in one copy."""
        if self.graph is not None:
            new, metrics, summary = self.graph.run(lr)
        elif self.mesh is not None:
            with sh.use_mesh(self.mesh):
                new, metrics, summary = self._step(state, data, lr)
        else:
            new, metrics, summary = self._step(
                state, data, torch.tensor(lr, dtype=torch.float32))
        host = summary.cpu().tolist()
        return new, dict(zip(metrics, host[1:])), bool(host[0])

    def run(self, *, fail_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        """Train to total_steps, resuming from the latest intact
        checkpoint.  `fail_hook(step)` is a supervisor's seam: called
        once per step BEFORE the attempt, it raises `HostFailure` (or
        any injected fault) to simulate losing a host.

        Returns the final state (tensors the caller owns) and history,
        the guard stats, the blames and `first_step_wall` -- the
        monotonic time at which the first step of THIS trainer completed
        (capture and restore included)."""
        t = self.tcfg
        state, start = self.maybe_restore()
        if self.graph is not None:
            self.graph.load(state)
            state = self.graph.state    # the compiled step's inputs
        history: List[Dict[str, Any]] = []
        lr_scale = 1.0
        first_step_wall: Optional[float] = None
        step = start
        while step < t.total_steps:
            if fail_hook is not None:
                fail_hook(step)
            batch = self.data.batch_at(step)   # deterministic skip-ahead
            ev = None
            if self.injector is not None:
                # Launch-class events raise/delay here; output-class
                # events poison the HOST batch so the real guard trips
                # on the device.
                try:
                    ev = self.injector.raise_or_delay(self._site)
                except faults.InjectedFault as e:
                    e.train_step = step   # a supervisor accounts steps
                    raise                 # lost by TRAIN step
                batch = faults.poison_batch(self.injector, ev, batch)
            data = self._put_batch(batch)
            self.guard.start_step()
            new_state, metrics, finite = self._attempt(
                state, data, t.lr * lr_scale)
            if finite:
                # commit
                if self.graph is not None:
                    self.graph.commit(new_state)
                else:
                    state = new_state
                self.guard.good_step()
                lr_scale = 1.0
                straggled = self.guard.straggled()
                if first_step_wall is None:
                    first_step_wall = time.monotonic()
                    self.first_step_wall = first_step_wall
                history.append({"step": step + 1, "loss": metrics["loss"]})
                if straggled:
                    # Straggler watchdog: checkpoint now so a slow host
                    # can be evicted without losing work.
                    self.save(step + 1, state, blocking=True)
                elif t.ckpt_dir and (step + 1) % t.ckpt_every == 0:
                    self.save(step + 1, state)
                step += 1
                continue
            # Non-finite: new_state is DISCARDED (rollback = the old
            # state), blame is localized eagerly, and the shared guard
            # decides between retry / skip / shrink-lr / give-up.
            blame = (self.localize_nonfinite(state, batch)
                     if t.blame else [])
            self.blames.append({"step": step, "grads": blame,
                                "injected": ev is not None})
            decision = self.guard.nonfinite()
            if decision.action == "give_up":
                raise NonFiniteStepError(step, blame)
            if decision.action == "skip":
                step += 1
                continue
            lr_scale = decision.lr_scale    # retry the SAME step
        if t.ckpt_dir:
            self.save(t.total_steps, state, blocking=True)
        if self._ckptr is not None:
            self._ckptr.wait()
        if self.graph is not None:   # the buffers are the next run's inputs
            state = tree_map(lambda a: a.clone(), state)
        return {"state": state, "history": history,
                "start_step": start, "guard_stats": dict(self.guard.stats),
                "blames": list(self.blames),
                "first_step_wall": first_step_wall}
