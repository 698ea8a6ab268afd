"""Deterministic fault injection for conv training (port of the training
side of `repro/serve/faults.py`).

One failure model for tests and drills: a kernel launch raises, a device
disappears, a step straggles, or an output comes back NaN/Inf.

  * `FaultSchedule.seeded(seed, ...)` precomputes, from one numpy seed,
    WHICH invocation of WHICH site fires WHICH fault -- a pure function
    of its arguments, so the same seed replays the same failure timing
    (and the same events as `repro`'s schedule for that seed).
  * `FaultInjector` walks a schedule at run time: each `step(site)`
    advances that site's invocation counter and returns the scheduled
    event (if any); `raise_or_delay` turns launch-class events into
    exceptions / latency, and `poison` applies output-class events to a
    host array.  Every fired event is recorded.
  * `train_site`, `training_schedule` and `poison_batch` are the
    trainer's seam: one site per workload, stepped once per step
    attempt, with output-class events stamped into the host batch so
    the trainer's real guard trips.
  * `inject_backend` wraps a `core.spec.ConvBackend` so every conv op
    consults the injector first -- the hook `core/spec.py::
    fallback_backend`'s ladder is tested against with real kernel paths
    underneath.  Output-class events poison the op's tensors where they
    lie (`poison_tensor`): no host round trip, no sync.
  * `corrupt_tile_cache` mangles the planner's tile-cache artifact
    (`kernels/tiling.py`) the three ways deployments see it break.

Every injected exception is an `InjectedFault`, raised before anything
is launched: on the card it is the one exception a ladder may degrade
on (`core.spec.may_degrade`).  Pure numpy at import: `inject_backend`
imports `core.spec` when called.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Launch-class kinds surface as exceptions/latency BEFORE the kernel
# output exists; output-class kinds corrupt the produced values.
LAUNCH_KINDS = ("kernel_exception", "device_loss", "latency_spike")
OUTPUT_KINDS = ("nan_output", "inf_output")
FAULT_KINDS = LAUNCH_KINDS + OUTPUT_KINDS


class InjectedFault(RuntimeError):
    """Base class of every injected failure (site/index/kind attached).
    `injected` marks the class for `core.spec.may_degrade`."""

    injected = True

    def __init__(self, site: str, index: int, kind: str):
        super().__init__(f"injected {kind} at {site}#{index}")
        self.site, self.index, self.kind = site, index, kind


class InjectedKernelFault(InjectedFault):
    """A kernel launch that raised (a refused launch, out of memory)."""


class InjectedDeviceLoss(InjectedFault):
    """A device that disappeared mid-step (host eviction, preemption)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: the `index`-th invocation of `site` fires
    `kind`.  `magnitude` is the latency-spike duration in seconds (other
    kinds ignore it)."""
    site: str
    index: int
    kind: str
    magnitude: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")


class FaultSchedule:
    """An immutable set of `FaultEvent`s, indexed by (site, index).

    Build explicitly from events (exact placement for state-machine
    tests) or via `seeded` (rate-driven, deterministic in the seed)."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self._by_key: Dict[Tuple[str, int], FaultEvent] = {
            (e.site, e.index): e for e in self.events}

    @classmethod
    def seeded(cls, seed: int, *, sites: Sequence[str], rate: float,
               horizon: int = 256, kinds: Sequence[str] = FAULT_KINDS,
               magnitude: float = 0.0) -> "FaultSchedule":
        """Rate-driven schedule: for each site, each invocation index
        below `horizon` fires with probability `rate`, drawing the kind
        uniformly from `kinds`.  A pure function of the arguments -- the
        same seed replays the same schedule exactly."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events = []
        for site in sites:
            fire = rng.random(horizon) < rate
            pick = rng.integers(0, len(kinds), horizon)
            for i in np.nonzero(fire)[0]:
                events.append(FaultEvent(site, int(i), kinds[int(pick[i])],
                                         magnitude))
        return cls(events)

    def lookup(self, site: str, index: int) -> Optional[FaultEvent]:
        return self._by_key.get((site, index))

    def __len__(self) -> int:
        return len(self.events)


class FaultInjector:
    """Replays a `FaultSchedule` against live invocation counters.

    One injector per run: counters start at zero, so the run sees the
    schedule from its beginning.  `fired` records every event actually
    hit, in order."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._counters: Dict[str, int] = defaultdict(int)
        self.fired: List[FaultEvent] = []

    def step(self, site: str) -> Optional[FaultEvent]:
        """Advance `site`'s invocation counter; return the scheduled
        event for the index just consumed (recorded), or None."""
        i = self._counters[site]
        self._counters[site] = i + 1
        ev = self.schedule.lookup(site, i)
        if ev is not None:
            self.fired.append(ev)
        return ev

    def calls(self, site: str) -> int:
        """How many invocations of `site` the injector has consumed."""
        return self._counters.get(site, 0)

    def raise_or_delay(self, site: str) -> Optional[FaultEvent]:
        """Consume one invocation of `site` and act on launch-class
        events: kernel exceptions and device losses raise, latency
        spikes sleep.  Output-class events are RETURNED (the caller
        applies them to the produced value via `poison`); None means the
        invocation is clean."""
        ev = self.step(site)
        if ev is None:
            return None
        if ev.kind == "kernel_exception":
            raise InjectedKernelFault(ev.site, ev.index, ev.kind)
        if ev.kind == "device_loss":
            raise InjectedDeviceLoss(ev.site, ev.index, ev.kind)
        if ev.kind == "latency_spike":
            time.sleep(max(0.0, ev.magnitude))
            return None
        return ev

    def poison(self, ev: Optional[FaultEvent], value):
        """Apply an output-class event to a host array: stamp NaN/Inf
        into the first element of every batch row (enough to trip any
        finite-ness guard, cheap to produce).  No-op for None."""
        if ev is None or ev.kind not in OUTPUT_KINDS:
            return value
        out = np.array(value, copy=True)
        bad = np.nan if ev.kind == "nan_output" else np.inf
        flat = out.reshape(out.shape[0], -1) if out.ndim > 1 \
            else out.reshape(1, -1)
        flat[:, 0] = bad
        return out.reshape(value.shape) if out.ndim > 1 else out[0]


def train_site(workload: str) -> str:
    """Fault-site name of a training workload's step loop (`train.cnn`,
    `train.gan`, `train.gan_gen`): the trainer consults it once per step
    ATTEMPT, so retries advance the counter the schedule was seeded
    against."""
    return f"train.{workload}"


def training_schedule(seed: int, *, workload: str, n_steps: int,
                      rate: float = 0.02,
                      kinds: Sequence[str] = ("nan_output",
                                              "latency_spike",
                                              "kernel_exception"),
                      magnitude: float = 0.0) -> FaultSchedule:
    """Seeded per-step fault schedule for a training run, on the same
    `FaultSchedule` that `host_failure_schedule` draws from.  Defaults
    exclude `device_loss`: host losses come from `host_failure_schedule`
    so the two stay independently seedable."""
    return FaultSchedule.seeded(
        seed, sites=[train_site(workload)], rate=rate, horizon=n_steps,
        kinds=kinds, magnitude=magnitude)


def poison_batch(injector: FaultInjector, ev: Optional[FaultEvent],
                 batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Apply an output-class event to a host batch dict: stamp NaN/Inf
    into the first float array (by sorted key: inputs / latents) --
    enough for the forward pass to carry non-finites into loss and
    grads, so the trainer's real guard trips.  Launch-class events and
    None pass the batch through untouched."""
    if ev is None or ev.kind not in OUTPUT_KINDS:
        return batch
    out = dict(batch)
    for key in sorted(out):
        v = out[key]
        if isinstance(v, np.ndarray) and \
                np.issubdtype(v.dtype, np.floating):
            out[key] = injector.poison(ev, v)
            break
    return out


def poison_tensor(ev: Optional[FaultEvent], t):
    """`FaultInjector.poison` for a tensor, on its own device and in its
    dtype: a copy with NaN/Inf in the first element of every batch row
    (of the only row for a 1-D tensor, which keeps its shape).  No-op
    for None, launch-class events and None tensors."""
    if ev is None or ev.kind not in OUTPUT_KINDS or t is None:
        return t
    out = t.contiguous().clone()
    rows = out.view(out.shape[0], -1) if out.dim() > 1 else out.view(1, -1)
    rows[:, 0] = float("nan") if ev.kind == "nan_output" else float("inf")
    return out


def inject_backend(base, injector: FaultInjector, *, prefix=None):
    """Wrap a `ConvBackend` so every op consults `injector` first.

    Site names are `<prefix>.<op>` (prefix defaults to the backend
    name) for the nine ops.  Launch-class events fire before the base op
    runs, so an injected exception launches nothing; output-class events
    poison every tensor the op returns (`poison_tensor`).  The name is
    `<base>@inject`; it is not `graphable`: a replay would skip its
    events."""
    from repro_torch.core.spec import backend_of_ops, resolve_backend

    be = resolve_backend(base)
    pre = prefix if prefix is not None else be.name

    def injected(op_name):
        call = getattr(be, op_name)

        def op(*args):
            ev = injector.raise_or_delay(f"{pre}.{op_name}")
            out = call(*args)
            if isinstance(out, tuple):
                return tuple(poison_tensor(ev, o) for o in out)
            return poison_tensor(ev, out)
        return op

    return backend_of_ops(f"{be.name}@inject", injected, graphable=False)


def corrupt_tile_cache(path, mode: str = "truncate", seed: int = 0) -> None:
    """Mangle an ECOFLOW_TILE_CACHE artifact the way real deployments
    see it break -- the warmup / planner side must warn and re-plan
    (kernels/tiling.py's load policy), never crash:

      * "truncate"  -- cut the file mid-document (pre-atomic-write crash);
      * "garbage"   -- overwrite with non-JSON bytes (torn copy);
      * "torn_row"  -- keep valid JSON but replace one row's plan fields
                       with nonsense (partial hand edit / version skew).

    The bytes written are `repro`'s for the same file, mode and seed."""
    import pathlib
    p = pathlib.Path(path)
    if mode == "truncate":
        text = p.read_text() if p.exists() else json.dumps(
            {"x": {"cin_tile": 8}})
        p.write_text(text[:max(1, len(text) // 2)])
    elif mode == "garbage":
        p.write_bytes(b"\x00\xffnot-json\x13" * 7)
    elif mode == "torn_row":
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            doc = {}
        if not isinstance(doc, dict) or not doc:
            doc = {"seed-row": {}}
        rng = np.random.default_rng(seed)
        key = sorted(doc)[int(rng.integers(len(doc)))]
        doc[key] = {"cin_tile": "not-an-int"}
        p.write_text(json.dumps(doc))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; expected "
                         f"truncate | garbage | torn_row")
