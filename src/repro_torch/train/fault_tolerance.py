"""The shared per-step guard and the host-loss schedule (port of
`repro/train/fault_tolerance.py`).

  * stragglers   -> the `StepGuard` step-timeout watchdog forces an early
    checkpoint so a slow host can be evicted without losing work.
  * bad numerics -> `StepGuard` owns the bounded non-finite policy
    (rollback + retry, then skip or shrink-lr, then give up) that the
    conv trainer applies.
  * host loss    -> `HostFailure`, and `host_failure_schedule` to seed
    when it happens; `survivors` and `elastic_mesh` build the largest
    (data, model) mesh from the ranks that are left, onto which a
    checkpoint restores (`train/checkpoint.py` saves whole leaves).

`train/supervisor.py::RunSupervisor` restarts a run on that mesh by
itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence


class HostFailure(RuntimeError):
    """Raised (by a schedule hook) when hosts are lost at a step; a run
    supervisor catches it, rebuilds the mesh from survivors, and resumes
    from the latest intact checkpoint."""

    def __init__(self, step: int, hosts: Sequence[int]):
        super().__init__(f"lost host(s) {sorted(hosts)} at step {step}")
        self.step = int(step)
        self.hosts = tuple(sorted(int(h) for h in hosts))


def elastic_layout(n_ranks: int, model_parallel: int) -> tuple:
    """(data, model) sizes for `n_ranks` survivors: the model axis halves
    until it divides them (TP is a property of the weight layout), the
    data axis takes the rest."""
    if n_ranks < 1:
        # Every host failed: surface it here, not deep inside a step.
        raise ValueError("elastic_mesh: no surviving ranks")
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, "
                         f"got {model_parallel}")
    mp = model_parallel
    while mp > 1 and n_ranks % mp:
        mp //= 2
    return n_ranks // mp, mp


def elastic_mesh(ranks: Optional[Sequence[int]] = None, *,
                 model_parallel: int = 16, device=None):
    """Largest ("data", "model") mesh from the surviving ranks (default:
    the whole group), keeping the model axis and shrinking the data axis,
    as elastic FSDP deployments drain failed hosts.  Every rank of the
    group calls it (creating the mesh's groups is collective); a rank
    outside it takes no part in its steps."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    dp, mp = elastic_layout(len(ranks), model_parallel)
    return make_mesh(ranks[:dp * mp], (dp, mp), ("data", "model"),
                     device=device)


def survivors(mesh, failed_host_ids: Sequence[int],
              devices_per_host: int = 8) -> list:
    """The mesh's ranks minus those on failed hosts (rank //
    devices_per_host is the host), in the mesh's order."""
    return [r for r in mesh.mesh.flatten().tolist()
            if r // devices_per_host not in failed_host_ids]


@dataclasses.dataclass(frozen=True)
class GuardDecision:
    """What to do after a non-finite step: `action` in
    retry | skip | give_up; `lr_scale` applies to retries only."""
    action: str
    lr_scale: float = 1.0


class StepGuard:
    """The per-step guard: one straggler watchdog plus one bounded
    non-finite retry state machine.

    Straggler side: `start_step()` before the step, `straggled()` after
    -- True when the step exceeded `step_timeout_s` (the caller forces a
    blocking checkpoint so the slow host can be evicted without losing
    work).

    Numerics side: on a non-finite step the caller rolls back to its
    last good state (steps never write their input state, so rollback is
    keeping it) and asks `nonfinite()` what to do next:

      failure 1              -> retry the SAME step at full lr (the
                                common transient case: a poisoned batch,
                                a one-off kernel glitch);
      failure 2..max_retries -> policy: "skip" abandons the step and
                                moves on; "shrink_lr" retries at
                                lr * lr_shrink**(failures-1);
      failure > max_retries  -> give_up (the caller raises -- the loss
                                surface itself is producing non-finite
                                updates and retrying would hide a bug).

    `good_step()` resets the per-step attempt counter; `stats` counts
    every decision."""

    def __init__(self, *, step_timeout_s: Optional[float] = None,
                 max_retries: int = 2, nonfinite_policy: str = "skip",
                 lr_shrink: float = 0.5):
        if nonfinite_policy not in ("skip", "shrink_lr"):
            raise ValueError(
                f"nonfinite_policy must be 'skip' or 'shrink_lr', "
                f"got {nonfinite_policy!r}")
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        self.step_timeout_s = step_timeout_s
        self.max_retries = max_retries
        self.nonfinite_policy = nonfinite_policy
        self.lr_shrink = lr_shrink
        self._t0: Optional[float] = None
        self._failures = 0
        self.stats = {"stragglers": 0, "nonfinite_steps": 0,
                      "retries": 0, "skips": 0, "lr_shrinks": 0,
                      "give_ups": 0}

    # -- straggler watchdog --------------------------------------------------
    def start_step(self):
        self._t0 = time.monotonic()

    def straggled(self) -> bool:
        if self.step_timeout_s is None or self._t0 is None:
            return False
        if time.monotonic() - self._t0 > self.step_timeout_s:
            self.stats["stragglers"] += 1
            return True
        return False

    # -- non-finite policy ---------------------------------------------------
    def nonfinite(self) -> GuardDecision:
        self._failures += 1
        n = self._failures
        if n == 1:
            self.stats["nonfinite_steps"] += 1
        if n > self.max_retries:
            self.stats["give_ups"] += 1
            self._failures = 0
            return GuardDecision("give_up")
        if n == 1:
            self.stats["retries"] += 1
            return GuardDecision("retry", 1.0)
        if self.nonfinite_policy == "skip":
            self.stats["skips"] += 1
            self._failures = 0
            return GuardDecision("skip")
        self.stats["retries"] += 1
        self.stats["lr_shrinks"] += 1
        return GuardDecision("retry", self.lr_shrink ** (n - 1))

    def good_step(self):
        self._failures = 0


def host_failure_schedule(seed: int, *, n_hosts: int, n_steps: int,
                          rate: float = 0.02) -> dict:
    """Deterministic host-loss schedule for elastic-training drills, on
    the same seeded `serve.faults.FaultSchedule` the training faults draw
    from.  Returns ``{step: [host_id, ...]}``."""
    from repro_torch.serve.faults import FaultSchedule

    sched = FaultSchedule.seeded(
        seed, sites=[f"host:{h}" for h in range(n_hosts)], rate=rate,
        horizon=n_steps, kinds=("device_loss",))
    out: dict = {}
    for ev in sched.events:
        out.setdefault(ev.index, []).append(int(ev.site.split(":")[1]))
    return {step: sorted(hosts) for step, hosts in sorted(out.items())}
