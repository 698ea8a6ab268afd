"""The shared per-step guard and the host-loss schedule (port of
`repro/train/fault_tolerance.py`).

  * stragglers   -> the `StepGuard` step-timeout watchdog forces an early
    checkpoint so a slow host can be evicted without losing work.
  * bad numerics -> `StepGuard` owns the bounded non-finite policy
    (rollback + retry, then skip or shrink-lr, then give up) that the
    conv trainer applies.
  * host loss    -> `HostFailure`, and `host_failure_schedule` to seed
    when it happens.

Not ported yet (ROADMAP A.12, multi-device): `elastic_mesh`, which builds
the largest (data, model) mesh from the surviving devices, and
`survivors`, with `train/supervisor.py`, which restarts a run on it.
Pure Python and numpy: no torch needed here.
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
