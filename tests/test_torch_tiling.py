"""The Hopper planner (`repro_torch/kernels/tiling.py`) on the CPU: the
part of `tests/test_tiling.py` that has a meaning on the card.

  * Cache keys follow `repro`'s `_cache_key` field for field, the mode
    segment naming the Hopper target; epilogue and strategy isolate keys.
  * Analytical mode is exactly the kernel modules' plans
    (`dconv_backward.plan`, `implicit_gemm.plan`) on every geometry of
    the plan tests' grids, and a repeat call is a memo lookup.
  * Autotune through fake runner factories (no card here; `_time_us`
    stubbed with fixed times): it sweeps every candidate, persists the
    fastest atomically, replays it with zero runner calls, skips a
    candidate that raises or disagrees, races both strategies into one
    `|st:auto` row, and refuses to time while a CUDA graph captures.
  * A corrupt file and a torn row warn and re-plan; an env flip re-plans.
  * `warmup_plans` resolves artifact rows first and never calls a runner.
"""
from __future__ import annotations

import json
import warnings

import pytest
import torch

from _torch_cases import BACKWARD_GRID, FWD_GRID, TCONV_GRID
from repro.core import spec as jspec
from repro.kernels import tiling as jtiling
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.kernels import dconv_backward as db
from repro_torch.kernels import implicit_gemm as ig
from repro_torch.kernels import tiling
from repro_torch.serve.faults import corrupt_tile_cache

SPEC = ConvSpec.make(stride=2, padding=1, filter_shape=4)
T1 = dict(x_shape=(4, 8, 8, 64), dy_shape=(4, 4, 4, 128))   # gan t1, B = 4
RELU = Epilogue(activation="relu")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Empty memos and no planner env around every test; the default
    cache path under tmp."""
    for var in ("ECOFLOW_TILING", "ECOFLOW_STRATEGY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ECOFLOW_TILE_CACHE", str(tmp_path / "default.json"))
    tiling._MEM_CACHE.clear()
    tiling._MEM_STRATEGY.clear()
    yield
    tiling._MEM_CACHE.clear()
    tiling._MEM_STRATEGY.clear()


class FakeRunners:
    """Runner factories for both strategies of every op: run(plan)
    returns ones (twos for the plans in `disagree`; it raises for those
    in `fail`); `_time_us` reads the µs of the plan the call ran from
    `times` (default 10).  Counts factory and runner calls."""

    def __init__(self, monkeypatch, times=None, fail=(), disagree=()):
        self.times, self.fail, self.disagree = dict(times or {}), fail, \
            disagree
        self.calls = self.made = 0
        self.last = None
        monkeypatch.setattr(tiling, "_time_us", self._time)
        for op in tiling.OPS:
            for st in tiling.STRATEGIES:
                monkeypatch.setitem(tiling._RUNNERS, (op, st), self.factory)

    def factory(self, spec, x_shape, dy_shape, epilogue=None):
        self.made += 1
        return self.run

    def run(self, plan):
        self.calls += 1
        self.last = plan
        if plan in self.fail:
            raise RuntimeError("launch refused")
        return torch.ones(3) * (2.0 if plan in self.disagree else 1.0)

    def _time(self, fn):
        fn()
        return self.times.get(self.last, 10.0)


def _jkey(op, spec, x_shape, dy_shape, ep, strategy):
    js = jspec.ConvSpec.make(stride=spec.stride, padding=spec.padding,
                             filter_shape=spec.filter_shape,
                             dilation=spec.dilation)
    je = None if ep is None else jspec.Epilogue(
        activation=ep.activation, bias=ep.bias, slope=ep.slope,
        scale=ep.scale)
    return jtiling._cache_key(op, js, x_shape, dy_shape, tiling.ITEMSIZE,
                              tiling.SMEM_BUDGET, False, je, strategy)


@pytest.mark.parametrize("op", tiling.OPS)
@pytest.mark.parametrize("strategy", ["phase", "implicit_gemm", "auto"])
def test_cache_key_schema_matches_repro(op, strategy):
    """Field for field and in order `repro`'s key, but for the mode
    segment: `repro`'s compiled TPU mode there, the Hopper target here."""
    spec = ConvSpec.make(stride=(2, 3), padding=(1, 0), filter_shape=(4, 3),
                         dilation=(1, 2))
    ep = Epilogue(activation="leaky_relu", slope=0.2, bias=True, scale=0.5)
    got = tiling._cache_key(op, spec, (3, 11, 13, 5), (3, 5, 3, 7), ep,
                            strategy).split("|")
    want = _jkey(op, spec, (3, 11, 13, 5), (3, 5, 3, 7), ep,
                 strategy).split("|")
    mode = want.index("compiled")
    assert got[mode] == tiling.TARGET == "sm90"
    assert got[:mode] + got[mode + 1:] == want[:mode] + want[mode + 1:]


def test_cache_key_isolates_epilogue_and_strategy():
    keys = {tiling._cache_key("input_grad", SPEC, T1["x_shape"],
                              T1["dy_shape"], ep, st)
            for ep in (None, RELU, Epilogue(activation="tanh"),
                       Epilogue(bias=True))
            for st in ("phase", "implicit_gemm", "auto")}
    assert len(keys) == 12


@pytest.mark.parametrize("op", ["backward", "ct_backward", "filter_grad"])
@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_analytical_backward_plans_are_the_kernel_plans(geom, op):
    _, B, N, K, S, P, D, ci, co = geom
    spec = ConvSpec.make(stride=S, padding=P, filter_shape=K, dilation=D)
    small = spec.out_size((N, N))
    engine = {"backward": "conv_backward", "ct_backward": "tconv_backward",
              "filter_grad": "filter_grad"}[op]
    for ep in (None, Epilogue(activation="relu", bias=True)):
        got = tiling.plan_tiles(op, spec, x_shape=(B, N, N, ci),
                                dy_shape=(B, *small, co), epilogue=ep)
        assert got == db.plan(engine, spec, B, (N, N), small, ci, co,
                              n_out=(N, N), bias=ep is not None)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("geom", TCONV_GRID)
def test_analytical_input_grad_plans_are_the_kernel_plans(geom, batch):
    s, d, k, p, _, o, cin, cout, slack = geom
    spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    n_out = tuple(n + slack for n in spec.input_size(o))
    kw = dict(x_shape=(batch, *n_out, cin), dy_shape=(batch, *o, cout))
    assert tiling.plan_tiles("input_grad", spec, **kw) == db.plan(
        "tconv_phase", spec, batch, n_out, o, cin, cout, n_out=n_out)
    assert tiling.plan_strategy("input_grad", spec, strategy="phase",
                                **kw)[1] == tiling.plan_tiles(
        "input_grad", spec, **kw)
    assert tiling.plan_strategy("input_grad", spec,
                                strategy="implicit_gemm", **kw) == (
        "implicit_gemm", ig.plan(spec, batch, n_out, o, cin, cout))


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("geom", FWD_GRID)
def test_analytical_forward_plans_are_the_kernel_plans(geom, batch):
    s, d, k, p = geom
    spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    for hw, cin, cout in (((11, 9), 5, 7), ((8, 8), 64, 24)):
        small = spec.out_size(hw)
        assert tiling.plan_tiles(
            "forward", spec, x_shape=(batch, *hw, cin),
            dy_shape=(batch, *small, cout), epilogue=RELU) == db.plan(
            "dconv_forward", spec, batch, hw, small, cin, cout)


def test_repeat_call_is_a_memo_lookup():
    tiling.plan_tiles("forward", SPEC, x_shape=(2, 9, 9, 3),
                      dy_shape=(2, 4, 4, 5))
    before = tiling.plan_cache_info()
    for _ in range(5):
        tiling.plan_tiles("forward", SPEC, x_shape=(2, 9, 9, 3),
                          dy_shape=(2, 4, 4, 5))
    after = tiling.plan_cache_info()
    assert after.hits == before.hits + 5 and after.misses == before.misses


def test_unknown_op_mode_and_strategy_rejected():
    with pytest.raises(ValueError, match="unknown op"):
        tiling.plan_tiles("conv3d", SPEC, **T1)
    with pytest.raises(ValueError, match="unknown tiling mode"):
        tiling.plan_tiles("forward", SPEC, mode="vmem", **T1)
    with pytest.raises(ValueError, match="unknown strategy"):
        tiling.plan_strategy("input_grad", SPEC, strategy="fastest", **T1)


def test_env_flip_replans(monkeypatch, tmp_path):
    monkeypatch.setenv("ECOFLOW_STRATEGY", "phase")
    assert tiling.plan_strategy("input_grad", SPEC, **T1)[0] == "phase"
    monkeypatch.setenv("ECOFLOW_STRATEGY", "implicit_gemm")
    assert tiling.plan_strategy("input_grad", SPEC, **T1)[0] == \
        "implicit_gemm"
    monkeypatch.setenv("ECOFLOW_STRATEGY", "bogus")
    with pytest.raises(ValueError, match="ECOFLOW_STRATEGY"):
        tiling.plan_strategy("input_grad", SPEC, **T1)
    monkeypatch.delenv("ECOFLOW_STRATEGY")
    own = tiling.plan_tiles("forward", SPEC, **T1)
    fast = db.candidates("dconv_forward", SPEC, 4, (4, 4), 64, 128)[-1]
    fake = FakeRunners(monkeypatch, times={fast: 1.0})
    monkeypatch.setenv("ECOFLOW_TILING", "autotune")
    monkeypatch.setenv("ECOFLOW_TILE_CACHE", str(tmp_path / "c.json"))
    assert tiling.plan_tiles("forward", SPEC, **T1) == fast != own
    assert fake.calls > 0
    monkeypatch.setenv("ECOFLOW_TILING", "analytical")
    assert tiling.plan_tiles("forward", SPEC, **T1) == own


def test_autotune_sweeps_persists_and_replays(monkeypatch, tmp_path):
    path = tmp_path / "tiles.json"
    cands = db.candidates("conv_backward", SPEC, 4, (4, 4), 64, 128,
                          n_out=(8, 8), bias=True)
    fast = cands[7]
    fake = FakeRunners(monkeypatch, times={cands[0]: 50.0, fast: 1.0})
    ep = Epilogue(activation="relu", bias=True)
    got = tiling.plan_tiles("backward", SPEC, mode="autotune",
                            tile_cache_path=path, epilogue=ep, **T1)
    assert got == fast
    # one reference run of the analytical plan, then each candidate: a
    # checked run plus the timed one
    assert fake.calls == 1 + 2 * len(cands) and fake.made == 1
    key = tiling._cache_key("backward", SPEC, T1["x_shape"], T1["dy_shape"],
                            ep, "phase")
    row = json.loads(path.read_text())[key]
    assert row["strategy"] == "phase" and row["us"] == 1.0
    assert db.BackwardPlan(**{f: row[f] for f in db.BackwardPlan._fields}) \
        == fast
    assert not list(tmp_path.glob(".*tmp"))      # atomic: no temp left
    tiling._MEM_CACHE.clear()
    fake.calls = fake.made = 0
    assert tiling.plan_tiles("backward", SPEC, mode="autotune",
                             tile_cache_path=path, epilogue=ep, **T1) == fast
    assert fake.calls == fake.made == 0          # replayed from the file


def test_autotune_skips_raising_and_disagreeing_candidates(monkeypatch,
                                                           tmp_path):
    cands = ig.candidates(SPEC, 4, (8, 8), (4, 4), 64, 128)
    bad, wrong, good = cands[1], cands[2], cands[3]
    FakeRunners(monkeypatch, fail={bad}, disagree={wrong},
                times={bad: 0.1, wrong: 0.2, good: 0.5})
    got = tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                               strategy="implicit_gemm",
                               tile_cache_path=tmp_path / "c.json", **T1)
    assert got == ("implicit_gemm", good)


def test_autotune_every_candidate_failing_keeps_the_analytical_plan(
        monkeypatch, tmp_path):
    cands = db.candidates("dconv_forward", SPEC, 4, (4, 4), 64, 128)
    FakeRunners(monkeypatch, fail=set(cands[1:]) | {cands[0]})
    path = tmp_path / "c.json"
    with pytest.raises(RuntimeError, match="refused"):
        # the analytical plan itself is the reference: its failure raises
        tiling.plan_tiles("forward", SPEC, mode="autotune",
                          tile_cache_path=path, **T1)
    FakeRunners(monkeypatch, disagree=set(cands[1:]))
    tiling._MEM_CACHE.clear()
    assert tiling.plan_tiles("forward", SPEC, mode="autotune",
                             tile_cache_path=path, **T1) == cands[0]


def test_autotune_race_writes_one_auto_row(monkeypatch, tmp_path):
    path = tmp_path / "race.json"
    phase = db.candidates("tconv_phase", SPEC, 4, (4, 4), 64, 128,
                          n_out=(8, 8))
    igs = ig.candidates(SPEC, 4, (8, 8), (4, 4), 64, 128)
    fake = FakeRunners(monkeypatch, times={phase[2]: 3.0, igs[4]: 2.0})
    got = tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                               tile_cache_path=path, epilogue=RELU, **T1)
    assert got == ("implicit_gemm", igs[4])
    doc = json.loads(path.read_text())
    key = tiling._cache_key("input_grad", SPEC, T1["x_shape"],
                            T1["dy_shape"], RELU, "auto")
    assert list(doc) == [key]
    assert doc[key]["strategy"] == "implicit_gemm"
    assert doc[key]["arms_us"] == {"phase": 3.0, "implicit_gemm": 2.0}
    tiling._MEM_CACHE.clear()
    tiling._MEM_STRATEGY.clear()
    fake.calls = 0
    assert tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                                tile_cache_path=path, epilogue=RELU,
                                **T1) == got
    assert fake.calls == 0


def test_autotune_refuses_to_time_during_a_capture(monkeypatch, tmp_path):
    fake = FakeRunners(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="captures a CUDA graph"):
        tiling.plan_tiles("forward", SPEC, mode="autotune",
                          tile_cache_path=tmp_path / "c.json", **T1)
    with pytest.raises(RuntimeError, match="captures a CUDA graph"):
        tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                             tile_cache_path=tmp_path / "c.json", **T1)
    assert fake.calls == 0
    # analytical plans need no timing: fine during a capture
    assert tiling.plan_tiles("forward", SPEC, **T1) == db.plan(
        "dconv_forward", SPEC, 4, (8, 8), (4, 4), 64, 128)


@pytest.mark.parametrize("mode", ["truncate", "garbage", "torn_row"])
def test_corrupt_cache_warns_and_replans(monkeypatch, tmp_path, mode):
    path = tmp_path / "c.json"
    cands = db.candidates("dconv_forward", SPEC, 4, (4, 4), 64, 128)
    FakeRunners(monkeypatch, times={cands[3]: 1.0})
    tiling.plan_tiles("forward", SPEC, mode="autotune", tile_cache_path=path,
                      **T1)
    corrupt_tile_cache(path, mode, seed=0)
    tiling._MEM_CACHE.clear()
    fake = FakeRunners(monkeypatch, times={cands[3]: 1.0})
    with pytest.warns(RuntimeWarning, match="autotune tile cache"):
        got = tiling.plan_tiles("forward", SPEC, mode="autotune",
                                tile_cache_path=path, **T1)
    assert got == cands[3] and fake.calls > 0      # re-planned
    key = tiling._cache_key("forward", SPEC, T1["x_shape"], T1["dy_shape"],
                            None, "phase")
    assert json.loads(path.read_text())[key]["us"] == 1.0   # rewritten


def test_row_of_another_geometry_is_torn(monkeypatch, tmp_path):
    """A row whose fields parse but are not a candidate of its key (a
    plan counted for other shapes) warns and re-plans."""
    path = tmp_path / "c.json"
    key = tiling._cache_key("forward", SPEC, T1["x_shape"], T1["dy_shape"],
                            None, "phase")
    other = db.plan("dconv_forward", SPEC, 64, (8, 8), (4, 4), 64, 128)
    path.write_text(json.dumps({key: other._asdict()}))
    fake = FakeRunners(monkeypatch)
    with pytest.warns(RuntimeWarning, match="malformed"):
        tiling.plan_tiles("forward", SPEC, mode="autotune",
                          tile_cache_path=path, **T1)
    assert fake.calls > 0


def test_warmup_plans_resolves_artifact_first_and_never_runs(monkeypatch,
                                                            tmp_path):
    path = tmp_path / "artifact.json"
    phase = db.candidates("tconv_phase", SPEC, 4, (4, 4), 64, 128,
                          n_out=(8, 8))
    t2 = dict(x_shape=(4, 16, 16, 32), dy_shape=(4, 8, 8, 64))
    FakeRunners(monkeypatch, times={phase[1]: 1.0})
    tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                         tile_cache_path=path, epilogue=RELU, **T1)
    # t2: a pinned row of the analytical race's strategy
    ig_t2 = ig.candidates(SPEC, 4, (16, 16), (8, 8), 32, 64)
    FakeRunners(monkeypatch, times={ig_t2[2]: 1.0})
    tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                         strategy="implicit_gemm", tile_cache_path=path,
                         epilogue=RELU, **t2)
    tiling._MEM_CACHE.clear()
    tiling._MEM_STRATEGY.clear()
    fake = FakeRunners(monkeypatch)
    entries = [("input_grad", SPEC, T1["x_shape"], T1["dy_shape"], RELU),
               ("input_grad", SPEC, t2["x_shape"], t2["dy_shape"], RELU),
               ("forward", SPEC, (4, 8, 8, 3), (4, 4, 4, 5))]
    out = tiling.warmup_plans(entries, tile_cache_path=path)
    assert fake.made == fake.calls == 0
    got = [(v["op"], v["strategy"], v["plan"], v["source"])
           for v in out.values()]
    assert got == [
        ("input_grad", "phase", phase[1], "artifact"),
        ("input_grad", "implicit_gemm", ig_t2[2], "artifact"),
        ("forward", "phase", db.plan("dconv_forward", SPEC, 4, (8, 8),
                                     (4, 4), 3, 5), "analytical")]
    assert list(out) == [
        tiling._cache_key(*e[:4], e[4] if len(e) > 4 else None, "auto")
        for e in entries]
    # the artifact's rows are primed: an autotune call replays them
    assert tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                                tile_cache_path=path, epilogue=RELU,
                                **T1) == ("phase", phase[1])
    assert fake.calls == 0


@pytest.mark.parametrize("mode", ["truncate", "garbage", "torn_row"])
def test_warmup_plans_on_a_corrupt_artifact_falls_back(monkeypatch,
                                                      tmp_path, mode):
    path = tmp_path / "artifact.json"
    FakeRunners(monkeypatch)
    tiling.plan_strategy("input_grad", SPEC, mode="autotune",
                         tile_cache_path=path, epilogue=RELU, **T1)
    corrupt_tile_cache(path, mode, seed=0)
    fake = FakeRunners(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tiling.warmup_plans(
            [("input_grad", SPEC, T1["x_shape"], T1["dy_shape"], RELU)],
            tile_cache_path=path)
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)
    (entry,) = out.values()
    assert entry["source"] == "analytical" and fake.calls == 0
    assert (entry["strategy"], entry["plan"]) == tiling.plan_strategy(
        "input_grad", SPEC, epilogue=RELU, **T1)
