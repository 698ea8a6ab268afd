"""RunSupervisor: drives a whole conv training run under the seeded fault
registry, surviving host loss by elastic re-meshing, over the ranks of a
`torch.distributed` group (port of `repro/train/supervisor.py`).

Every rank of the group runs one supervisor with the same arguments;
they take the same decisions from the same schedule, so they stay in
step.  The recovery protocol, per caught failure:

  1. classify -- a `HostFailure` (from the host-loss schedule hook) or
     an `InjectedDeviceLoss` (from the per-step injector site) names
     which hosts died; an `InjectedKernelFault` keeps the mesh;
  2. shrink   -- `fault_tolerance.survivors` drops the dead hosts' ranks
     (a rank's host is its device id // devices_per_host, its id its
     rank in the first group); the dead hosts' processes leave the
     group and return, ending cleanly; the survivors join a FRESH
     `gloo` group (a `file://` store under `rendezvous`, numbered by
     segment) and `elastic_mesh` builds the largest valid (data, model)
     mesh of it (the model axis halves until it divides);
  3. restore  -- a fresh `ConvTrainer` on the new mesh restores the
     latest intact checkpoint, laid out on the shrunk mesh (torn
     checkpoints fall back with a RuntimeWarning); the data pipeline
     skips ahead for free (batches are pure in (seed, step));
  4. account  -- steps lost (failure step minus restored step), one
     trainer rebuild ("recompiles", `repro`'s jit), and the recovery
     wallclock (catching the failure to the new trainer's first
     completed step).

Non-finite steps never reach the supervisor: the trainer's guard and
`StepGuard` policy handle rollback / retry inside the run.  The
supervisor restarts only on faults that invalidate the mesh or the
process, bounded by `max_recoveries`.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.serve.faults import InjectedDeviceLoss, InjectedFault
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig
from repro_torch.train.fault_tolerance import (HostFailure, elastic_mesh,
                                               survivors)


class _Ids:
    """The device ids of a mesh's ranks in mesh order: what `survivors`
    reads of a mesh."""

    def __init__(self, ids: Sequence[int]):
        self.mesh = torch.tensor(list(ids))


class RunSupervisor:
    """Owns the ranks of one run: builds meshes, trainers and the
    recovery report.

    `host_schedule` is `{step: [host_id, ...]}` (the shape
    `fault_tolerance.host_failure_schedule` returns); each entry fires
    once, at the first trainer step >= its key that a live trainer
    reaches.  `injector` is threaded into every trainer, so per-step
    faults replay from the same seeded registry across recoveries.
    `torch.distributed` must be initialized by the caller (`gloo`, the
    group whose ranks are the run's devices); after a shrink the
    surviving ranks end in a group of their own, which the caller
    destroys as it would the first, and a lost rank's `run` returns
    `{"lost": True, "report": ...}` with no group left."""

    def __init__(self, tcfg: ConvTrainerConfig, *, rendezvous: str,
                 devices_per_host: int = 1, model_parallel: int = 2,
                 host_schedule: Optional[Dict[int, List[int]]] = None,
                 injector=None, max_recoveries: int = 8, device=None):
        if not tcfg.ckpt_dir:
            raise ValueError("RunSupervisor needs tcfg.ckpt_dir: "
                             "recovery restores from checkpoints")
        self.tcfg = tcfg
        self.rendezvous = rendezvous
        self.devices = list(range(dist.get_world_size()))
        self.me = dist.get_rank()
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.host_schedule = dict(host_schedule or {})
        self.injector = injector
        self.max_recoveries = max_recoveries
        self.device = device
        self.report: Dict[str, Any] = {
            "recoveries": [], "steps_lost": 0, "recompiles": 0,
            "recovery_wallclock_s": 0.0, "meshes": [],
            "host_losses": 0, "device_losses": 0, "kernel_faults": 0,
            # StepGuard stats summed over every trainer segment (each
            # elastic mesh gets a fresh trainer + guard)
            "guard": {"stragglers": 0, "nonfinite_steps": 0,
                      "retries": 0, "skips": 0, "lr_shrinks": 0,
                      "give_ups": 0}}

    def _live_hosts(self) -> List[int]:
        return sorted({d // self.devices_per_host for d in self.devices})

    def _hook(self):
        """Per-step hook for the trainer: fire every pending scheduled
        host loss whose step has arrived (>=, not ==: a step skipped by
        the guard or lost to an earlier recovery must not defuse the
        failure)."""
        pending = self.host_schedule

        def hook(step: int):
            due = [s for s in pending if s <= step]
            if not due:
                return
            hosts: List[int] = []
            for s in due:
                hosts.extend(pending.pop(s))
            live = set(self._live_hosts())
            hosts = sorted(set(h for h in hosts if h in live))
            if hosts and len(hosts) < len(live):
                raise HostFailure(step, hosts)
            # Losing every host (or only already-dead ones) is not an
            # elastic event -- nothing to do.
        return hook

    def _shrink(self, dead_hosts: Sequence[int]) -> bool:
        """Drop the dead hosts' ranks; the survivors re-form as a fresh
        group.  False on a rank that was lost (it has left the group)."""
        self.devices = survivors(_Ids(self.devices), list(dead_hosts),
                                 self.devices_per_host)
        dist.destroy_process_group()
        if self.me not in self.devices:
            return False
        store = os.path.join(self.rendezvous,
                             f"group_{len(self.report['recoveries'])}")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=self.devices.index(self.me),
                                world_size=len(self.devices))
        return True

    def run(self) -> Dict[str, Any]:
        """Drive the run to total_steps across as many elastic meshes as
        the storm requires; returns the final trainer output plus the
        recovery report (on a lost rank: `lost` and the report)."""
        t_recover_from: Optional[float] = None
        failed_step: Optional[int] = None
        while True:
            mesh = elastic_mesh(model_parallel=self.model_parallel,
                                device=self.device)
            self.report["meshes"].append(
                {ax: int(mesh.size(i))
                 for i, ax in enumerate(mesh.mesh_dim_names)})
            trainer = ConvTrainer(self.tcfg, mesh=mesh, injector=self.injector,
                                  device=self.device)
            if t_recover_from is not None:
                # The fresh trainer is the rebuild; steps lost = failure
                # step minus the step the intact checkpoint restores.
                restored = ckpt.latest_step(self.tcfg.ckpt_dir) or 0
                self.report["recompiles"] += 1
                self.report["steps_lost"] += max(0, failed_step - restored)
            try:
                out = trainer.run(fail_hook=self._hook())
            except HostFailure as e:
                dead, kind, step = e.hosts, "host_losses", e.step
            except InjectedDeviceLoss as e:
                # The injector names an invocation, not a host: map the
                # loss to the highest-id live host (deterministic).
                if len(self._live_hosts()) <= 1:
                    raise   # nothing left to shrink to
                dead = [self._live_hosts()[-1]]
                kind, step = "device_losses", getattr(e, "train_step",
                                                      e.index)
            except InjectedFault as e:
                # Kernel fault: the mesh is fine -- restart the loop from
                # the latest checkpoint on the same ranks.
                dead, kind = [], "kernel_faults"
                step = getattr(e, "train_step", e.index)
            else:
                self._account_segment(trainer, t_recover_from)
                out["report"] = self.report
                return out
            self._account_segment(trainer, t_recover_from)
            self._on_failure(kind, step, dead)
            t_recover_from, failed_step = time.monotonic(), step
            if dead and not self._shrink(dead):
                return {"lost": True, "report": self.report}

    def _account_segment(self, trainer: ConvTrainer,
                         t_recover_from: Optional[float]):
        """Close out one trainer segment: fold its guard stats into the
        run-wide totals, and (when the segment was itself a recovery)
        account the recovery wallclock -- failure catch to the fresh
        trainer's first completed step (restore and rebuild included)
        -- even when that trainer later dies too."""
        for k, v in trainer.guard.stats.items():
            self.report["guard"][k] += v
        if t_recover_from is not None and \
                trainer.first_step_wall is not None:
            self.report["recovery_wallclock_s"] += (
                trainer.first_step_wall - t_recover_from)

    def _on_failure(self, kind: str, step: int, dead_hosts: Sequence[int]):
        if len(self.report["recoveries"]) >= self.max_recoveries:
            raise RuntimeError(
                f"supervisor exceeded max_recoveries={self.max_recoveries}")
        self.report[kind] += 1
        self.report["recoveries"].append(
            {"kind": kind, "step": int(step),
             "dead_hosts": sorted(int(h) for h in dead_hosts)})
