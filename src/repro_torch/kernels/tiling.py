"""The Hopper planner: each conv launch's tiles and splits, and which
kernel family runs the transposed conv (port of
`repro/kernels/tiling.py`).

`repro`'s planner models a TPU core's VMEM and Pallas grid steps.  The
port's kernels have plans of their own, pure functions of the shapes:
`dconv_backward.plan` (a `BackwardPlan`: the implicit-GEMM engine's
tiles and splits, for the two backwards, the filter gradient and the two
forwards) and `implicit_gemm.plan` (an `IGPlan`: B.5's tile, Cin tile
and Cout chunk).  Every conv launcher takes its plan from here, which
puts `repro`'s modes, cache and warmup in front of both:

  * **analytical** (default; `ECOFLOW_TILING`): exactly the kernel
    modules' plans, memoized (`plan_cache_info`).
  * **autotune** (`ECOFLOW_TILING=autotune` or `mode="autotune"`): each
    kernel module registers a runner factory (`register_autotune_runner`)
    that launches its kernel at a given plan on card-resident inputs.
    The planner times every candidate (`dconv_backward.candidates`,
    `implicit_gemm.candidates`, the sets `scripts/backward_plan_sweep.py`
    and `scripts/implicit_gemm_sweep.py` walk) with CUDA events, holds
    its output against the analytical plan's within AUTOTUNE_TOL, skips
    a candidate that disagrees or raises, and persists the fastest to a
    JSON cache: `ECOFLOW_TILE_CACHE`, default
    ~/.cache/ecoflow/tile_cache.json, published atomically.

`plan_strategy` also picks the kernel family of the standalone input
gradient, the only op with two: the phase kernel (B.2, the engine's dx
role) or the predicated implicit GEMM (B.5).  `ECOFLOW_STRATEGY` =
phase | implicit_gemm | auto (default).  In analytical mode "auto" is a
Hopper race, a cost model of the two kernels built from their plans
(`race_costs_us`): CTAs per SM over SM_COUNT, each thread's slabs (the
engine) or live taps (B.5, from the predicated-lane waste), the bytes
each CTA stages, and a fixed cost per launch, its constants fitted to
both kernels' times at the GAN generator's layers.  A strategy whose
plan raises is out of the race.  In autotune mode "auto" sweeps both
arms and one `|st:auto` row records the winner and both arms' times.

Every plan is made for one operand dtype (`dtype=`, fp32 or bf16): the
implicit GEMM stages its operands in their own dtype, so its shared
memory, and both arms' staged bytes in the race, count at the launch's
itemsize, and an autotune runner times its candidates on inputs of that
dtype.  Cache keys are `repro`'s (`_cache_key`) field for field, the
dtype's bytes (`|w4` fp32, `|w2` bf16) included, so a bf16 plan and an
fp32 plan never share an entry.  Two segments differ: the mode segment
names the Hopper target (TARGET), so a TPU row is never read as a
Hopper plan, and the budget segment holds the card's shared memory per
CTA.  `ECOFLOW_VMEM_BUDGET` has no Hopper meaning and is not read.
A row that does not parse as one of the port's candidate plans for its
key follows `repro`'s torn-row policy: a RuntimeWarning, then re-plan.
The planner never sweeps while the current stream captures a CUDA graph
(`train/step_graph.py`): a plan not resolved before the capture raises.
"""
from __future__ import annotations

import functools
import json
import math
import os
import pathlib
import time
import warnings
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import ecoflow
from repro_torch.core.spec import ConvSpec, Epilogue

OPS = ("filter_grad", "forward", "input_grad", "backward", "ct_backward")
STRATEGIES = ("phase", "implicit_gemm")
MODES = ("analytical", "autotune")

TARGET = "sm90"          # the key's mode segment: Hopper, compiled
SMEM_BUDGET = 232448     # dynamic shared memory of one CTA on the H100
ITEMSIZE = 4             # the bytes of fp32, the default operand dtype
AUTOTUNE_TOL = 1e-4      # an fp32 candidate against the analytical plan's
# A bf16 candidate: both round once from fp32 sums that differ in order,
# so one bf16 ulp (rtol, and atol relative to the output's largest value).
AUTOTUNE_TOL_BF16 = 2.0 ** -7
AUTOTUNE_ITERS = 5       # timed launches per candidate, after one warm one

# The engine's op for each of `repro`'s planner ops (the input gradient's
# phase strategy is the engine's dx role alone).
_ENGINE_OPS = {"forward": "dconv_forward", "input_grad": "tconv_phase",
               "backward": "conv_backward", "ct_backward": "tconv_backward",
               "filter_grad": "filter_grad"}

# The race's cost model (race_costs_us).  SM_COUNT: H100 SXM.  The fixed
# and per-operation costs are least-squares fits to both kernels' times at
# the generator's t1-t3, B = 4 and 64 (PERF.md section 6's race table,
# chip_smoke.py phase 3 on an H100 at 700 W); L2_BYTES_US prices the
# operands each CTA stages through shared memory.
SM_COUNT = 132
ENGINE_FIXED_US = 18.0
ENGINE_OP_US = 0.004      # per thread operation x resident CTA on an SM
IG_FIXED_US = 6.5
IG_OP_US = 0.0018         # per thread operation x 128 resident threads
L2_BYTES_US = 5.5e6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _geometry(x_shape, dy_shape):
    b, nh, nw, cin = x_shape
    _, oh, ow, cout = dy_shape
    return b, (nh, nw), (oh, ow), cin, cout


def _ig(op: str, strategy: str) -> bool:
    return op == "input_grad" and strategy == "implicit_gemm"


def _itemsize(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the conv kernels take float32 or bfloat16, got "
                        f"{dtype}")
    return dtype.itemsize


def _analytical(op: str, spec: ConvSpec, x_shape, dy_shape,
                ep: Optional[Epilogue], strategy: str,
                dtype: torch.dtype = torch.float32):
    """The kernel module's own plan of one launch (ValueError from
    `implicit_gemm.plan` when no tile fits)."""
    from repro_torch.kernels import dconv_backward, implicit_gemm

    b, n_out, small, cin, cout = _geometry(x_shape, dy_shape)
    if _ig(op, strategy):
        return implicit_gemm.plan(spec, b, n_out, small, cin, cout,
                                  _itemsize(dtype))
    return dconv_backward.plan(_ENGINE_OPS[op], spec, b, n_out, small, cin,
                               cout, n_out=n_out,
                               bias=ep is not None and ep.bias)


def _candidates(op: str, spec: ConvSpec, x_shape, dy_shape,
                ep: Optional[Epilogue], strategy: str,
                dtype: torch.dtype = torch.float32) -> list:
    from repro_torch.kernels import dconv_backward, implicit_gemm

    b, n_out, small, cin, cout = _geometry(x_shape, dy_shape)
    if _ig(op, strategy):
        return implicit_gemm.candidates(spec, b, n_out, small, cin, cout,
                                        _itemsize(dtype))
    return dconv_backward.candidates(_ENGINE_OPS[op], spec, b, small, cin,
                                     cout, n_out=n_out,
                                     bias=ep is not None and ep.bias)


# ---------------------------------------------------------------------------
# The analytical race
# ---------------------------------------------------------------------------

def race_costs_us(spec: ConvSpec, x_shape, dy_shape,
                  ep: Optional[Epilogue] = None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """{strategy: modeled µs} of the input gradient dy (`dy_shape`) ->
    dx (`x_shape`) on each kernel at its analytical plan; a strategy
    whose plan raises is absent.

    phase (the engine): each thread of a CTA runs its split's slabs of
    GEMM_BK, each slab BM*BN*GEMM_BK / 256 FMAs and the slab's staged
    loads; the CTAs per SM (all waves) run one after another.
    implicit_gemm: each thread loops over every tap per Cout chunk (the
    predicate, one branch per warp) and sums the live taps -- the
    scheduled taps less `predicated_mac_fraction` -- over Cout, each
    step a halo read, Cin_t weights and Cin_t FMAs; the threads resident
    on an SM share it.  Each arm is also bounded below by the bytes its
    CTAs stage, at L2_BYTES_US (`dtype`'s bytes per element)."""
    from repro_torch.kernels import dconv_backward as db

    b, n_out, small, cin, cout = _geometry(x_shape, dy_shape)
    out = {}
    p = _analytical("input_grad", spec, x_shape, dy_shape, ep, "phase",
                    dtype)
    bm, bn = db.TILES[p.tile]
    k = db.reduction("tconv_phase", spec, small, cin, cout, n_out)
    slabs = _cdiv(db.split_chunk(k, p.splits), db.GEMM_BK)
    ctas = p.tiles * p.splits
    work = slabs * db.GEMM_BK * (bm * bn + 2 * (bm + bn)) / 256
    staged = ctas * slabs * db.GEMM_BK * (bm + bn) * _itemsize(dtype)
    out["phase"] = ENGINE_FIXED_US + max(
        ENGINE_OP_US * work * _cdiv(ctas, SM_COUNT), staged / L2_BYTES_US)
    try:
        q = _analytical("input_grad", spec, x_shape, dy_shape, ep,
                        "implicit_gemm", dtype)
    except ValueError:
        return out
    kh, kw = spec.filter_shape
    taps = kh * kw
    live = taps * (1.0 - ecoflow.predicated_mac_fraction(spec, small))
    chunks = _cdiv(cout, q.chunk)
    work = 4 * chunks * taps + live * cout * (q.cin_t + 1 + q.cin_t / 4)
    resident = max(1.0, _cdiv(q.ctas, SM_COUNT) * q.threads / 128)
    staged = q.ctas * chunks * q.smem / q.stages
    out["implicit_gemm"] = IG_FIXED_US + max(IG_OP_US * work * resident,
                                             staged / L2_BYTES_US)
    return out


@functools.lru_cache(maxsize=4096)
def _auto_strategy(op: str, spec: ConvSpec, x_shape, dy_shape,
                   ep: Optional[Epilogue],
                   dtype: torch.dtype = torch.float32) -> str:
    """Memoized analytical race (ECOFLOW_STRATEGY=auto, every call)."""
    if op != "input_grad":
        return "phase"
    costs = race_costs_us(spec, x_shape, dy_shape, ep, dtype)
    return min(STRATEGIES, key=lambda s: costs.get(s, math.inf))


@functools.lru_cache(maxsize=4096)
def _planned(op: str, spec: ConvSpec, x_shape, dy_shape,
             ep: Optional[Epilogue], strategy: str,
             dtype: torch.dtype = torch.float32):
    """Memoized analytical plan: the wrappers resolve a plan on every
    launch, so the steady-state cost is a lookup.  The strategy and the
    dtype key it, so an ECOFLOW_STRATEGY flip re-plans."""
    return _analytical(op, spec, x_shape, dy_shape, ep, strategy, dtype)


def plan_cache_info():
    """Hit / miss counts of the memoized analytical plans."""
    return _planned.cache_info()


# ---------------------------------------------------------------------------
# Autotune: runners, timing, the on-disk cache
# ---------------------------------------------------------------------------

# Runner factories by (op, strategy), registered by the kernel modules at
# import: factory(spec, x_shape, dy_shape, epilogue=None[, dtype]) ->
# run(plan), which launches the kernel at `plan` on fixed inputs of
# `dtype` (given for bf16 only) and returns its output(s).
_RUNNERS: Dict[tuple, Callable] = {}
# Autotuned plans by cache key, and the strategy of each |st:auto key.
_MEM_CACHE: Dict[str, object] = {}
_MEM_STRATEGY: Dict[str, str] = {}
_SPIN_MS_PER_CYCLE: Dict[int, float] = {}


def register_autotune_runner(op: str, factory: Callable,
                             strategy: str = "phase") -> None:
    _RUNNERS[(op, strategy)] = factory


def cache_path() -> pathlib.Path:
    env = os.environ.get("ECOFLOW_TILE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(os.path.expanduser("~")) / ".cache" / "ecoflow" / \
        "tile_cache.json"


def _cache_key(op: str, spec: ConvSpec, x_shape, dy_shape,
               ep: Optional[Epilogue] = None, strategy: str = "phase",
               dtype: torch.dtype = torch.float32) -> str:
    """`repro`'s key: the geometry, the dtype's bytes (`|w`), the budget,
    the mode (here the Hopper target), the strategy (`|st:`, "auto" for
    the race's row) and the epilogue (`|ep:`)."""
    sh, sw = spec.stride
    ph, pw = spec.padding
    kh, kw = spec.filter_shape
    dh, dw = spec.dilation
    b, nh, nw, cin = x_shape
    _, oh, ow, cout = dy_shape
    tag = "none" if ep is None else ep.tag
    return (f"{op}|b{b}|n{nh}x{nw}|o{oh}x{ow}|k{kh}x{kw}|s{sh}x{sw}"
            f"|p{ph}x{pw}|d{dh}x{dw}|ci{cin}|co{cout}|w{_itemsize(dtype)}"
            f"|vm{SMEM_BUDGET}|{TARGET}|st:{strategy}|ep:{tag}")


def _load_disk_cache(path: pathlib.Path) -> dict:
    """The cache file as a dict; {} when absent.  A file that is not a
    JSON object (truncated, torn, not text) warns and reads as empty:
    the next sweep replaces it."""
    try:
        doc = json.loads(path.read_text())
    except OSError:
        return {}
    except (UnicodeDecodeError, ValueError):
        doc = None
    if not isinstance(doc, dict):
        warnings.warn(
            f"corrupt autotune tile cache at {path} (not a JSON object); "
            f"ignoring it and re-tuning -- the next sweep rewrites it",
            RuntimeWarning, stacklevel=2)
        return {}
    return doc


def _store_disk_cache(path: pathlib.Path, doc: dict) -> None:
    """Atomic publish: a temp file in the same directory, then
    `os.replace` over the cache, so a racing reader never sees a torn
    file and the last writer wins."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, path)
    except OSError:
        pass   # the cache is an optimization; never fail the conv over it


def _row(plan) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in plan._asdict().items()}


def _plan_from_rec(op: str, rec, spec: ConvSpec, x_shape, dy_shape,
                   ep: Optional[Epilogue], strategy: str,
                   dtype: torch.dtype = torch.float32):
    """The plan a cache row names, or None with a RuntimeWarning when the
    row is not one of this launch's candidate plans (malformed, torn, or
    another geometry's)."""
    from repro_torch.kernels.dconv_backward import BackwardPlan
    from repro_torch.kernels.implicit_gemm import IGPlan

    kind = IGPlan if _ig(op, strategy) else BackwardPlan
    try:
        fields = {f: rec[f] for f in kind._fields}
        if "halo" in fields:
            fields["halo"] = tuple(fields["halo"])
        plan = kind(**fields)
        if plan in _candidates(op, spec, x_shape, dy_shape, ep, strategy,
                               dtype):
            return plan
    except (KeyError, TypeError, ValueError, AttributeError):
        pass
    warnings.warn(f"malformed autotune tile cache record for op {op!r} "
                  f"({strategy}); ignoring it and re-tuning",
                  RuntimeWarning, stacklevel=2)
    return None


def _auto_from_rec(op: str, rec, spec: ConvSpec, x_shape, dy_shape,
                   ep: Optional[Epilogue],
                   dtype: torch.dtype = torch.float32):
    """(strategy, plan) of a `|st:auto` row, or None with a RuntimeWarning
    when the row names no strategy or no candidate plan of it."""
    st = rec.get("strategy") if isinstance(rec, dict) else None
    if st not in STRATEGIES:
        warnings.warn(f"malformed autotune tile cache record for op {op!r} "
                      f"(auto): no strategy; ignoring it and re-tuning",
                      RuntimeWarning, stacklevel=2)
        return None
    plan = _plan_from_rec(op, rec, spec, x_shape, dy_shape, ep, st, dtype)
    return None if plan is None else (st, plan)


def _spin_ms_per_cycle() -> float:
    """ms per cycle of `torch.cuda._sleep` on the current device, measured
    once per device."""
    dev = torch.cuda.current_device()
    if dev not in _SPIN_MS_PER_CYCLE:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        _SPIN_MS_PER_CYCLE[dev] = start.elapsed_time(end) / 1_000_000
    return _SPIN_MS_PER_CYCLE[dev]


def _time_us(fn) -> float:
    """Device time of one call: CUDA events around AUTOTUNE_ITERS calls,
    after a warm one, queued behind a spin kernel that holds the stream
    until the host has queued them all -- otherwise the host's launch
    rate, not the card, would time a short kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    cycles = int(2 * AUTOTUNE_ITERS * host_ms / _spin_ms_per_cycle())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(min(cycles, 4_000_000_000))
    start.record()
    for _ in range(AUTOTUNE_ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / AUTOTUNE_ITERS


def _agree(a, b) -> bool:
    """One output of a candidate against the analytical plan's: within
    AUTOTUNE_TOL in fp32, one bf16 ulp in bf16."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.float(), b.float()
        scale = float(b.abs().max()) if b.numel() else 0.0
        return bool(torch.allclose(a, b, atol=AUTOTUNE_TOL_BF16 * scale,
                                   rtol=AUTOTUNE_TOL_BF16))
    return bool(torch.allclose(a, b, atol=AUTOTUNE_TOL, rtol=AUTOTUNE_TOL))


def _close(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        (a is None and b is None) or (
            a is not None and b is not None and _agree(a, b))
        for a, b in zip(got, want))


def _refuse_capture(key: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the tile planner would time kernels for {key} while the "
            f"current stream captures a CUDA graph; resolve every plan "
            f"before the capture (a warm-up step)")


def _sweep(op: str, spec: ConvSpec, x_shape, dy_shape,
           ep: Optional[Epilogue], strategy: str, factory: Callable,
           dtype: torch.dtype = torch.float32):
    """Time every candidate of one (op, strategy) that agrees with the
    analytical plan's output: (best µs, best plan), or (inf, None) when
    none ran.  Raises ValueError when the strategy has no plan."""
    plans = _candidates(op, spec, x_shape, dy_shape, ep, strategy, dtype)
    # A factory that times fp32 only need not take the dtype.
    run = factory(spec, x_shape, dy_shape, epilogue=ep,
                  **({} if dtype == torch.float32 else {"dtype": dtype}))
    want = run(plans[0])          # the analytical plan comes first
    best = (math.inf, None)
    for plan in plans:
        try:
            if not _close(run(plan), want):
                continue
            us = _time_us(lambda p=plan: run(p))
        except (RuntimeError, ValueError):   # refused or failed: skip it
            continue
        if us < best[0]:
            best = (us, plan)
    return best


def _autotune_plan(op: str, spec: ConvSpec, x_shape, dy_shape,
                   ep: Optional[Epilogue], strategy: str,
                   path: pathlib.Path, runner_factory: Optional[Callable],
                   dtype: torch.dtype = torch.float32):
    key = _cache_key(op, spec, x_shape, dy_shape, ep, strategy, dtype)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _load_disk_cache(path)
    if key in disk:
        plan = _plan_from_rec(op, disk[key], spec, x_shape, dy_shape, ep,
                              strategy, dtype)
        if plan is not None:
            _MEM_CACHE[key] = plan
            return plan
    factory = runner_factory or _RUNNERS.get((op, strategy))
    if factory is None:   # nothing to time: the analytical plan, unsaved
        return _planned(op, spec, x_shape, dy_shape, ep, strategy, dtype)
    _refuse_capture(key)
    us, plan = _sweep(op, spec, x_shape, dy_shape, ep, strategy, factory,
                      dtype)
    if plan is None:      # every candidate failed: the analytical plan
        return _planned(op, spec, x_shape, dy_shape, ep, strategy, dtype)
    disk[key] = dict(_row(plan), us=round(us, 3), strategy=strategy)
    _store_disk_cache(path, disk)
    _MEM_CACHE[key] = plan
    return plan


def _autotune_strategy(op: str, spec: ConvSpec, x_shape, dy_shape,
                       ep: Optional[Epilogue], path: pathlib.Path,
                       runner_factory: Optional[Callable],
                       dtype: torch.dtype = torch.float32):
    """Both arms swept through their runners; ONE `|st:auto` row records
    the winner (`strategy`) and each arm's best µs (`arms_us`).  An
    explicit `runner_factory` stands in for the phase runner only."""
    key = _cache_key(op, spec, x_shape, dy_shape, ep, "auto", dtype)
    if key in _MEM_STRATEGY:
        return _MEM_STRATEGY[key], _MEM_CACHE[key]
    disk = _load_disk_cache(path)
    hit = None if key not in disk else _auto_from_rec(
        op, disk[key], spec, x_shape, dy_shape, ep, dtype)
    if hit is not None:
        _MEM_STRATEGY[key], _MEM_CACHE[key] = hit
        return hit
    arms = {}
    for st in STRATEGIES:
        factory = _RUNNERS.get((op, st)) or (
            runner_factory if st == "phase" else None)
        if factory is None:
            continue
        _refuse_capture(key)
        try:
            us, plan = _sweep(op, spec, x_shape, dy_shape, ep, st, factory,
                              dtype)
        except ValueError:        # no plan for this strategy: out
            continue
        if plan is not None:
            arms[st] = (us, plan)
    if not arms:          # nothing timed: the analytical race, unsaved
        st = _auto_strategy(op, spec, x_shape, dy_shape, ep, dtype)
        return st, _planned(op, spec, x_shape, dy_shape, ep, st, dtype)
    st = min(arms, key=lambda s: arms[s][0])
    us, plan = arms[st]
    disk[key] = dict(_row(plan), us=round(us, 3), strategy=st,
                     arms_us={s: round(a[0], 3) for s, a in arms.items()})
    _store_disk_cache(path, disk)
    _MEM_CACHE[key], _MEM_STRATEGY[key] = plan, st
    return st, plan


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def _normalize(op, x_shape, dy_shape, epilogue, mode):
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if epilogue is not None and epilogue.is_identity:
        epilogue = None
    mode = os.environ.get("ECOFLOW_TILING", "analytical") if mode is None \
        else mode
    if mode not in MODES:
        raise ValueError(f"unknown tiling mode {mode!r} (set explicitly or "
                         f"via ECOFLOW_TILING); expected one of {MODES}")
    return (tuple(map(int, x_shape)), tuple(map(int, dy_shape)), epilogue,
            mode)


def plan_tiles(op: str, spec: ConvSpec, *, x_shape, dy_shape,
               mode: Optional[str] = None,
               runner_factory: Optional[Callable] = None,
               tile_cache_path=None,
               epilogue: Optional[Epilogue] = None,
               dtype: torch.dtype = torch.float32):
    """The plan of one launch on the phase kernels: a
    `dconv_backward.BackwardPlan`.

    op        -- "forward" (dconv_forward) | "input_grad" (tconv_phase) |
                 "backward" (conv_backward) | "ct_backward"
                 (tconv_backward) | "filter_grad".
    x_shape   -- (B, Nh, Nw, Cin): the forward input, the transposed
                 conv's output, the backward's dx (n_out).
    dy_shape  -- (B, Oh, Ow, Cout): the forward output / cotangent.
    mode      -- "analytical" | "autotune"; default ECOFLOW_TILING.
    epilogue  -- the launch's fused epilogue: its bias adds the db role,
                 its tag enters the cache key.
    dtype     -- the operands' dtype, fp32 or bf16: its bytes enter the
                 cache key, and an autotune times inputs of it.
    """
    x_shape, dy_shape, ep, mode = _normalize(op, x_shape, dy_shape,
                                             epilogue, mode)
    if mode == "autotune":
        path = pathlib.Path(tile_cache_path) if tile_cache_path \
            else cache_path()
        return _autotune_plan(op, spec, x_shape, dy_shape, ep, "phase",
                              path, runner_factory, dtype)
    return _planned(op, spec, x_shape, dy_shape, ep, "phase", dtype)


def plan_strategy(op: str, spec: ConvSpec, *, x_shape, dy_shape,
                  mode: Optional[str] = None,
                  runner_factory: Optional[Callable] = None,
                  tile_cache_path=None,
                  epilogue: Optional[Epilogue] = None,
                  strategy: Optional[str] = None,
                  dtype: torch.dtype = torch.float32) -> tuple:
    """The kernel family and its plan for one launch: ("phase",
    BackwardPlan) or ("implicit_gemm", IGPlan).  Parameters as
    `plan_tiles`, plus `strategy`: "phase" | "implicit_gemm" | "auto" |
    None (ECOFLOW_STRATEGY, default "auto").  Only the standalone
    "input_grad" has two families; every other op takes "phase", pinned
    or not."""
    x_shape, dy_shape, ep, mode = _normalize(op, x_shape, dy_shape,
                                             epilogue, mode)
    if strategy is None:
        strategy = os.environ.get("ECOFLOW_STRATEGY", "auto")
    if strategy not in STRATEGIES + ("auto",):
        raise ValueError(f"unknown strategy {strategy!r} (set explicitly "
                         f"or via ECOFLOW_STRATEGY); expected one of "
                         f"{STRATEGIES + ('auto',)}")
    if op != "input_grad":
        strategy = "phase"
    if mode == "autotune":
        path = pathlib.Path(tile_cache_path) if tile_cache_path \
            else cache_path()
        if strategy == "auto":
            return _autotune_strategy(op, spec, x_shape, dy_shape, ep, path,
                                      runner_factory, dtype)
        return strategy, _autotune_plan(op, spec, x_shape, dy_shape, ep,
                                        strategy, path, runner_factory,
                                        dtype)
    if strategy == "auto":
        strategy = _auto_strategy(op, spec, x_shape, dy_shape, ep, dtype)
    return strategy, _planned(op, spec, x_shape, dy_shape, ep, strategy,
                              dtype)


def warmup_plans(entries, *, tile_cache_path=None) -> dict:
    """Serving-startup warmup: `(strategy, plan)` of every launch a
    bucket makes, never timing a kernel.  `entries` holds `(op, spec,
    x_shape, dy_shape[, epilogue])` tuples (the models' `*_plan_requests`).
    Per entry, against the artifact at `tile_cache_path` (default
    `cache_path()`):

      1. its `|st:auto` row: the measured winner and its plan;
      2. else the analytical race's strategy, with that strategy's
         pinned row for the plan if there is one;
      3. else the analytical plan.

    A corrupt artifact or row warns and falls through; artifact hits are
    primed into the autotune memo, so an autotune process replays them
    instead of sweeping.  Returns ``{cache_key: {"op", "strategy",
    "plan", "source"}}``, source "artifact" or "analytical"."""
    path = pathlib.Path(tile_cache_path) if tile_cache_path \
        else cache_path()
    disk = _load_disk_cache(path)
    out = {}
    for entry in entries:
        op, spec, x_shape, dy_shape = entry[:4]
        ep = entry[4] if len(entry) > 4 else None
        x_shape, dy_shape, ep, _ = _normalize(op, x_shape, dy_shape, ep,
                                              "analytical")
        strategy = plan = None
        source = "artifact"
        key_auto = _cache_key(op, spec, x_shape, dy_shape, ep, "auto")
        hit = None if key_auto not in disk else _auto_from_rec(
            op, disk[key_auto], spec, x_shape, dy_shape, ep)
        if hit is not None:
            strategy, plan = hit
            _MEM_STRATEGY[key_auto], _MEM_CACHE[key_auto] = hit
        else:
            strategy = _auto_strategy(op, spec, x_shape, dy_shape, ep)
            key_st = _cache_key(op, spec, x_shape, dy_shape, ep, strategy)
            rec = disk.get(key_st)
            if rec is not None:
                plan = _plan_from_rec(op, rec, spec, x_shape, dy_shape, ep,
                                      strategy)
            if plan is not None:
                _MEM_CACHE[key_st] = plan
            else:
                plan = _planned(op, spec, x_shape, dy_shape, ep, strategy)
                source = "analytical"
        out[key_auto] = {"op": op, "strategy": strategy, "plan": plan,
                         "source": source}
    return out
