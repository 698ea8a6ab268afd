"""Fault-tolerant continuous-batching serving for the conv workloads (port
of `repro/serve/conv_engine.py`): GAN generation (`gan_gen`) and atrous
segmentation (`aspp`) on one card.

  * **Geometry buckets.**  Each request's payload shape normalizes --
    through the models' `*_plan_requests` helpers, i.e. `ConvSpec.make` --
    into a bucket keyed by (workload kind, payload shape), served at a
    fixed slot batch.
  * **Bounded admission.**  Submission beyond `queue_limit` is SHED
    (counted, rejected), never buffered without limit.  Slots refill from
    the queue on every launch.
  * **Degradation ladder.**  Per bucket, launches on the CPU walk
    ``cuda -> torch_zero_free -> reference``.  A rung that raises (or
    NaNs twice) degrades the request to the next rung and feeds a
    per-(bucket, rung) circuit breaker: enough consecutive failures
    quarantine the rung (OPEN); after a cooldown it half-opens and the
    next launch re-probes it.
  * **The ladder on the card.**  On a CUDA device the default ladder is
    the single rung ``("cuda",)``; a longer one serves only when the
    caller names it.  There a rung degrades only on an injected fault
    (raised before anything is launched) or an output that an injected
    event poisoned (or whose inputs were non-finite); any other
    exception propagates from the rung that raised it
    (`core.spec.may_degrade`), and so does, as a `RuntimeError`, a
    non-finite output of finite inputs that nothing injected: a plain
    rung must not hide a kernel that failed to build, launch or compute,
    and no rung may run on a CUDA context that error may have broken.
  * **Deadlines, retries, NaN guard.**  Expired requests are dropped at
    dequeue and withheld at completion.  Failed attempts back off
    exponentially (bounded); a non-finite output is retried once on the
    same rung, then degrades (on the card, as above, only where it may).

  * **Compile once.**  On the card each (bucket, rung) launch is one
    CUDA graph (`serve/conv_graph.py`, the counterpart of `repro`'s
    `jax.jit` per (bucket, backend)): its first launch runs the forward
    eagerly and is served, the capture follows, and every later launch
    -- a NaN retry too -- is a copy into the graph's input buffer, one
    replay and one copy out.  `health()["captures"]` counts the
    captures, `replay_launches` the kernel launches the replays made
    (each capture's own count, once per replay; `ops.LAUNCHES` counts
    only the eager launches and the captures).  A rung whose backend
    does host-side work on every op that a replay would skip
    (`ConvBackend.graphable` false, as `serve.faults.inject_backend`
    makes it for its events) stays eager.  On the CPU
    every launch is eager and no graph exists.
  * **Warmup.**  `warmup` resolves every bucket's launch plans from the
    shipped tile-cache artifact (`tiling.warmup_plans`: never an autotune
    sweep; a corrupt artifact warns and falls back to the analytical
    planner) and, with `compile`, builds the kernels and runs one dummy
    batch through the primary rung (on the card: its eager launch and
    its capture).

Fault injection (`serve/faults.py`) hooks each attempt at site
``f"{kind}:{backend}"``, outside the graph as `repro`'s is outside
`jit`: launch-class events fire before the forward pass (or replay),
output-class events poison the host result.  With no injector attached
the fast path is the forward through the rung: no extra launch, no
extra sync.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spec import may_degrade, resolve_backend
from repro_torch.device import resolve_device
from repro_torch.kernels import build, tiling
from repro_torch.models import gan, vision
from repro_torch.serve.conv_graph import ConvGraph
from repro_torch.serve.faults import OUTPUT_KINDS, FaultInjector

DEFAULT_LADDER = ("cuda", "torch_zero_free", "reference")   # CPU engines
CARD_LADDER = ("cuda",)

KINDS = ("gan_gen", "aspp")


@dataclasses.dataclass
class ConvRequest:
    """One inference request.

    kind       -- "gan_gen" (payload: a (z_dim,) latent) or "aspp"
                  (payload: an (H, W, C) image).
    deadline_s -- optional deadline RELATIVE to submission; the absolute
                  deadline is stamped by `submit`.  An expired request is
                  dropped (counted as a miss), never served late silently.
    """
    uid: Optional[int]
    kind: str
    payload: np.ndarray
    deadline_s: Optional[float] = None
    deadline: Optional[float] = dataclasses.field(default=None, repr=False)
    submitted: Optional[float] = dataclasses.field(default=None, repr=False)


class CircuitBreaker:
    """Per-(bucket, rung) quarantine: CLOSED -> OPEN after
    `fail_threshold` consecutive failures; OPEN counts down `cooldown`
    launch opportunities, then HALF_OPEN admits one probe whose outcome
    closes or re-opens.  `transitions` records every state change."""

    def __init__(self, fail_threshold: int = 2, cooldown: int = 3):
        if fail_threshold < 1 or cooldown < 1:
            raise ValueError("fail_threshold and cooldown must be >= 1")
        self.fail_threshold = fail_threshold
        self.cooldown = cooldown
        self.state = "closed"
        self.failures = 0
        self._cool = 0
        self.transitions: List[Tuple[str, str]] = []

    def _to(self, state: str) -> None:
        if state != self.state:
            self.transitions.append((self.state, state))
            self.state = state

    def allow(self) -> bool:
        """May the next launch try this rung?  An OPEN breaker consumes
        one cooldown tick per refusal, so quarantine is measured in launch
        opportunities -- deterministic, no clocks."""
        if self.state == "closed":
            return True
        if self.state == "open":
            self._cool -= 1
            if self._cool > 0:
                return False
            self._to("half_open")
            return True
        return True   # half_open: the single-threaded engine probes once

    def record_success(self) -> None:
        self.failures = 0
        self._to("closed")

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.fail_threshold:
            self.failures = 0
            self._cool = self.cooldown
            self._to("open")


@dataclasses.dataclass
class _Bucket:
    key: tuple
    kind: str
    payload_shape: tuple
    specs: tuple              # the ConvSpec-normalized launch geometry
    breakers: Dict[str, CircuitBreaker]


class ConvServeEngine:
    """Continuous-batching request manager over the GAN generator and the
    ASPP atrous head.  Single-threaded and synchronous: `submit` admits
    or sheds, `run` drains the queue, `serve` does both.  `device=None`
    means the card, and raises when there is none; `ladder=None` means
    `CARD_LADDER` on the card and `DEFAULT_LADDER` on the CPU."""

    def __init__(self, *, gan_params=None, aspp_params=None,
                 slot_batch: int = 4, queue_limit: int = 32,
                 ladder: Optional[Sequence[str]] = None,
                 injector: Optional[FaultInjector] = None,
                 fail_threshold: int = 2, cooldown: int = 3,
                 retry_backoff_s: float = 0.0, max_backoff_s: float = 0.05,
                 rates: Tuple[int, ...] = (1, 2, 4),
                 fuse_epilogue: bool = True, device=None,
                 tile_cache_path=None):
        if slot_batch < 1 or queue_limit < 1:
            raise ValueError("slot_batch and queue_limit must be >= 1")
        self.device = resolve_device(device)
        if ladder is None:
            ladder = CARD_LADDER if self.device.type == "cuda" \
                else DEFAULT_LADDER
        if not ladder:
            raise ValueError("ladder must name at least one backend")
        self.gan_params = None if gan_params is None else \
            {k: v.to(self.device) for k, v in gan_params.items()}
        self.aspp_params = None if aspp_params is None else \
            {k: v.to(self.device) for k, v in aspp_params.items()}
        self.slot_batch = int(slot_batch)
        self.queue_limit = int(queue_limit)
        self.ladder = tuple(ladder)
        self.injector = injector
        self.fail_threshold = int(fail_threshold)
        self.cooldown = int(cooldown)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.rates = tuple(rates)
        self.fuse_epilogue = bool(fuse_epilogue)
        self.tile_cache_path = tile_cache_path

        self._queue: deque = deque()
        self._buckets: Dict[tuple, _Bucket] = {}
        # (bucket key, rung) -> its compiled launch on the card.
        self.graphs: Dict[tuple, ConvGraph] = {}
        self._pool = None     # the graphs' shared memory pool
        self._next_uid = 0
        self._latencies_us: List[float] = []
        self.stats: Dict[str, object] = {
            "submitted": 0, "completed": 0, "sheds": 0, "failures": 0,
            "retries": 0, "fallbacks": 0, "nan_events": 0,
            "deadline_misses": 0, "kernel_faults": 0, "quarantines": 0,
            "reprobes": 0, "launches": 0, "warmup": None,
        }

    # -- buckets ----------------------------------------------------------

    def _bucket(self, kind: str, payload_shape: tuple) -> _Bucket:
        key = (kind, tuple(int(s) for s in payload_shape))
        b = self._buckets.get(key)
        if b is not None:
            return b
        entries = self._plan_entries(kind, key[1])
        b = _Bucket(
            key=key, kind=kind, payload_shape=key[1],
            specs=tuple(e[1] for e in entries),
            breakers={name: CircuitBreaker(self.fail_threshold,
                                           self.cooldown)
                      for name in self.ladder})
        self._buckets[key] = b
        return b

    def _plan_entries(self, kind: str, payload_shape: tuple):
        """The bucket's launch geometry, normalized through
        `ConvSpec.make` by the model helpers."""
        if kind == "gan_gen":
            if self.gan_params is None:
                raise ValueError("no gan_params: cannot serve gan_gen")
            return gan.generator_plan_requests(
                self.gan_params, self.slot_batch,
                fuse_epilogue=self.fuse_epilogue)
        if kind == "aspp":
            if self.aspp_params is None:
                raise ValueError("no aspp_params: cannot serve aspp")
            return vision.atrous_plan_requests(
                self.aspp_params, (self.slot_batch,) + payload_shape,
                rates=self.rates, fuse_epilogue=self.fuse_epilogue)
        raise ValueError(f"unknown request kind {kind!r}; "
                         f"expected one of {KINDS}")

    def forward_fn(self, kind: str, backend: str):
        """The bucket's launch callable for `backend`: a batch tensor on
        the engine's device in, the output batch out.  It holds the
        params, not the engine: a graph of it held by the engine makes no
        reference cycle."""
        fuse, rates = self.fuse_epilogue, self.rates
        if kind == "gan_gen":
            params = self.gan_params
            return lambda batch: gan.generator_apply(
                params, batch, backend=backend, fuse_epilogue=fuse)
        if kind == "aspp":
            params = self.aspp_params
            return lambda batch: vision.atrous_head_apply(
                params, batch, rates=rates, backend=backend,
                fuse_epilogue=fuse)
        raise ValueError(f"unknown request kind {kind!r}")

    def graphed(self, backend: str) -> bool:
        """Does `backend`'s rung launch through a CUDA graph?  On the card,
        unless its backend does host-side work on every op that a replay
        would skip (`ConvBackend.graphable`, false for `inject_backend`)."""
        return self.device.type == "cuda" and \
            resolve_backend(backend).graphable

    def _forward(self, bucket: _Bucket, backend: str,
                 batch: np.ndarray) -> np.ndarray:
        if self.graphed(backend):
            key = (bucket.key, backend)
            graph = self.graphs.get(key)
            if graph is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = self.graphs[key] = ConvGraph(
                    self.forward_fn(bucket.kind, backend), batch.shape,
                    self.device, self._pool)
            return graph(batch)
        with torch.no_grad():
            out = self.forward_fn(bucket.kind, backend)(
                torch.from_numpy(batch).to(self.device))
        return out.cpu().numpy()

    @property
    def captures(self) -> int:
        """CUDA-graph captures of this engine's launches (0 on the CPU)."""
        return sum(g.captures for g in self.graphs.values())

    @property
    def replay_launches(self) -> Counter:
        """Kernel launches made by the graphs' replays, by kernel."""
        return sum((g.replay_launches for g in self.graphs.values()),
                   Counter())

    # -- warmup -----------------------------------------------------------

    def warmup(self, shapes: Sequence[Tuple[str, tuple]], *,
               compile: bool = False) -> dict:
        """Pre-plan every bucket's launches from the tile-cache artifact
        (`tile_cache_path`, default ECOFLOW_TILE_CACHE; never an autotune
        sweep, a corrupt artifact warns and falls back to the analytical
        planner) and, with `compile`, build the CUDA kernels (all sources
        at once) and run one dummy batch through the primary rung (on the
        card its first launch: eager, then captured).  `shapes` lists
        ``(kind, payload_shape)`` pairs."""
        entries = []
        for kind, payload_shape in shapes:
            bucket = self._bucket(kind, tuple(payload_shape))
            entries.extend(self._plan_entries(kind, bucket.payload_shape))
        plans = tiling.warmup_plans(entries,
                                    tile_cache_path=self.tile_cache_path)
        summary = {
            "buckets": len(self._buckets),
            "plans": len(plans),
            "artifact": sum(1 for v in plans.values()
                            if v["source"] == "artifact"),
            "analytical": sum(1 for v in plans.values()
                              if v["source"] == "analytical"),
        }
        if compile:
            if self.device.type == "cuda":
                build.build()
            for kind, payload_shape in shapes:
                bucket = self._bucket(kind, tuple(payload_shape))
                batch = np.zeros((self.slot_batch,) + bucket.payload_shape,
                                 np.float32)
                self._forward(bucket, self.ladder[0], batch)
        self.stats["warmup"] = summary
        return summary

    # -- admission --------------------------------------------------------

    def submit(self, req: ConvRequest) -> bool:
        """Admit `req` into the bounded queue; False (and a shed count)
        when the queue is at the admission bound."""
        self.stats["submitted"] += 1
        if len(self._queue) >= self.queue_limit:
            self.stats["sheds"] += 1
            return False
        if req.uid is None:
            req.uid = self._next_uid
            self._next_uid += 1
        req.submitted = time.monotonic()
        if req.deadline_s is not None:
            req.deadline = req.submitted + req.deadline_s
        self._bucket(req.kind, tuple(req.payload.shape))
        self._queue.append(req)
        return True

    # -- serving loop -----------------------------------------------------

    def serve(self, requests: Sequence[ConvRequest]) -> Dict[int, np.ndarray]:
        """Submit a batch of requests (shedding past the admission bound)
        and drain the queue.  Returns {uid: result} for every admitted
        request that completed in deadline."""
        for r in requests:
            self.submit(r)
        return self.run()

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue: take up to `slot_batch` same-bucket requests
        from the front, launch them through the degradation ladder,
        repeat."""
        results: Dict[int, np.ndarray] = {}
        while self._queue:
            cohort, bucket = self._take_cohort()
            if not cohort:
                continue
            out = self._launch(bucket, cohort)
            if out is None:       # every rung failed for this cohort
                self.stats["failures"] += len(cohort)
                continue
            now = time.monotonic()
            for i, r in enumerate(cohort):
                if r.deadline is not None and now > r.deadline:
                    self.stats["deadline_misses"] += 1
                    continue
                self.stats["completed"] += 1
                self._latencies_us.append((now - r.submitted) * 1e6)
                results[r.uid] = out[i]
        return results

    def _take_cohort(self):
        """Pop up to `slot_batch` requests sharing the front request's
        bucket, preserving the order of everything left behind.
        Already-expired requests are dropped here (deadline miss)."""
        now = time.monotonic()
        while self._queue:
            head = self._queue[0]
            if head.deadline is not None and now > head.deadline:
                self._queue.popleft()
                self.stats["deadline_misses"] += 1
                continue
            break
        if not self._queue:
            return [], None
        head = self._queue[0]
        bucket = self._bucket(head.kind, tuple(head.payload.shape))
        cohort, rest = [], deque()
        while self._queue and len(cohort) < self.slot_batch:
            r = self._queue.popleft()
            if r.deadline is not None and now > r.deadline:
                self.stats["deadline_misses"] += 1
                continue
            if (r.kind, tuple(r.payload.shape)) == bucket.key:
                cohort.append(r)
            else:
                rest.append(r)
        rest.extend(self._queue)
        self._queue = rest
        return cohort, bucket

    def _rungs(self, bucket: _Bucket) -> List[str]:
        """The ladder filtered through the breakers.  When every rung is
        quarantined the LAST rung is forced anyway."""
        allowed = [name for name in self.ladder
                   if bucket.breakers[name].allow()]
        return allowed if allowed else [self.ladder[-1]]

    def _launch(self, bucket: _Bucket, cohort) -> Optional[np.ndarray]:
        """One slot-batch launch through the ladder.  Returns the host
        output batch, or None when every rung (and the NaN retry budget)
        is exhausted."""
        batch = np.zeros((self.slot_batch,) + bucket.payload_shape,
                         np.float32)
        for i, r in enumerate(cohort):
            batch[i] = r.payload
        self.stats["launches"] += 1
        n = len(cohort)
        on_card = self.device.type == "cuda"
        attempt = 0
        rungs = self._rungs(bucket)
        for ri, backend in enumerate(rungs):
            breaker = bucket.breakers[backend]
            if breaker.state == "half_open":
                self.stats["reprobes"] += 1
            nan_budget = 1
            while True:
                if attempt > 0:
                    self.stats["retries"] += 1
                    self._backoff(attempt)
                attempt += 1
                try:
                    ev = None
                    if self.injector is not None:
                        ev = self.injector.raise_or_delay(
                            f"{bucket.kind}:{backend}")
                    out = self._forward(bucket, backend, batch)
                    if ev is not None:
                        out = self.injector.poison(ev, out)
                except Exception as exc:  # noqa: BLE001 - the ladder's rule
                    self.stats["kernel_faults"] += 1
                    self._fail(breaker)
                    if not may_degrade(exc, on_card):
                        raise     # on the card: surfaces where it arose
                    break         # degrade: next rung serves this cohort
                if not np.all(np.isfinite(out[:n])):
                    self.stats["nan_events"] += 1
                    if (on_card and (ev is None or ev.kind not in OUTPUT_KINDS)
                            and np.all(np.isfinite(batch[:n]))):
                        # On the card a non-finite output of finite inputs
                        # that no injected event poisoned is a kernel
                        # fault: it surfaces, no rung stands in for it.
                        self._fail(breaker)
                        raise RuntimeError(
                            f"non-finite output of the {backend!r} rung "
                            f"for bucket {bucket.key} on the card, with "
                            f"finite inputs and no fault injected")
                    if nan_budget > 0:
                        nan_budget -= 1
                        continue  # transient? one retry on the same rung
                    self._fail(breaker)
                    break         # systematic: degrade to the next rung
                breaker.record_success()
                if ri > 0:
                    self.stats["fallbacks"] += 1
                return out
        return None

    def _fail(self, breaker: CircuitBreaker) -> None:
        before = breaker.state
        breaker.record_failure()
        if breaker.state == "open" and before != "open":
            self.stats["quarantines"] += 1

    def _backoff(self, attempt: int) -> None:
        if self.retry_backoff_s <= 0:
            return
        time.sleep(min(self.max_backoff_s,
                       self.retry_backoff_s * (2.0 ** (attempt - 1))))

    # -- health -----------------------------------------------------------

    def health(self) -> dict:
        """Stats snapshot plus latency percentiles, breaker states, each
        breaker's transitions and the CUDA-graph captures."""
        lat = np.asarray(self._latencies_us, np.float64)
        out = dict(self.stats)
        out["p50_us"] = float(np.percentile(lat, 50)) if lat.size else None
        out["p99_us"] = float(np.percentile(lat, 99)) if lat.size else None
        out["queue_depth"] = len(self._queue)
        out["captures"] = self.captures
        out["breakers"] = {
            f"{k[0]}:{name}": br.state
            for k, b in self._buckets.items()
            for name, br in b.breakers.items()}
        out["transitions"] = {
            f"{k[0]}:{name}": list(br.transitions)
            for k, b in self._buckets.items()
            for name, br in b.breakers.items()}
        return out
