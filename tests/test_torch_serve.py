"""The port's serving slice on the CPU against `repro`: the GAN generator
and the ASPP head from `repro`'s own params (through
`convert.params_from_numpy`), and `ConvServeEngine` against `repro`'s
engine on the same requests -- results, sheds, deadline misses and
circuit-breaker transitions, also under the same seeded fault schedules
(`repro`'s acceptance pins: full degradation, a mixed storm, the NaN
guard, quarantine and re-probe) -- plus the ladder's card rule with the
device faked.  Narrow widths; fp32 at rtol = atol = 1e-4 (DESIGN.md
Sec. 2.3)."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.core import spec as jspec
from repro.models import gan as jgan
from repro.models import vision as jvision
from repro.serve import conv_engine as jeng
from repro.serve import faults as jfaults
from repro_torch.convert import params_from_numpy
from repro_torch.core import spec as tspec
from repro_torch.models import gan as tgan
from repro_torch.models import vision as tvision
from repro_torch.serve import conv_engine as teng
from repro_torch.serve import faults as tfaults

Z_DIM, BASE = 8, 8
IMG = (8, 8, 3)
BACKENDS = ["cuda", "torch_zero_free", "reference"]


def _repro_tree(init, seed, **kw):
    """A param tree in `repro`'s exact layout -- the keys and shapes of
    `init`, read with jax.eval_shape so nothing compiles -- filled from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def gan_np():
    return _repro_tree(jgan.generator_init, 0, z_dim=Z_DIM, base=BASE,
                       out_ch=3)


@pytest.fixture(scope="module")
def aspp_np():
    return _repro_tree(jvision.atrous_head_init, 1, in_ch=3, width=4,
                       n_classes=4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_generator_matches_repro(gan_np, backend):
    z = np.random.default_rng(0).standard_normal((3, Z_DIM)).astype(
        np.float32)
    want = jax.jit(lambda p, z_: jgan.generator_apply(
        p, z_, backend="xla_zero_free"))(gan_np, z)
    with torch.no_grad():
        got = tgan.generator_apply(params_from_numpy(gan_np, device="cpu"),
                                   torch.tensor(z), backend=backend)
    assert tuple(got.shape) == (3, 32, 32, 3)
    assert_allclose(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_atrous_head_matches_repro(aspp_np, backend):
    x = np.random.default_rng(1).standard_normal((2,) + IMG).astype(
        np.float32)
    want = jax.jit(lambda p, x_: jvision.atrous_head_apply(
        p, x_, backend="xla_zero_free"))(aspp_np, x)
    with torch.no_grad():
        got = tvision.atrous_head_apply(
            params_from_numpy(aspp_np, device="cpu"), torch.tensor(x),
            backend=backend)
    assert tuple(got.shape) == (2,) + IMG[:2] + (4,)
    assert_allclose(got, want)


def test_plan_requests_match_repro(gan_np, aspp_np):
    tp_g = params_from_numpy(gan_np, device="cpu")
    tp_a = params_from_numpy(aspp_np, device="cpu")

    def norm(entries):
        return [(op, (s.stride, s.padding, s.filter_shape, s.dilation),
                 tuple(xs), tuple(ds), None if ep is None else ep.tag)
                for op, s, xs, ds, ep in entries]

    assert norm(tgan.generator_plan_requests(tp_g, 4)) == \
        norm(jgan.generator_plan_requests(gan_np, 4))
    assert norm(tvision.atrous_plan_requests(tp_a, (4,) + IMG)) == \
        norm(jvision.atrous_plan_requests(aspp_np, (4,) + IMG))


# Standard deviation of a standard normal truncated to [-2, 2].
_TRUNC_STD = 0.8796256610


def test_inits_have_repro_shapes_and_scales():
    """Same keys, shapes and dtype as `repro`'s inits (read without
    compiling), and the spread of `repro`'s draws: truncated normal
    scaled by 1/sqrt(fan_in) for the generator, normal for the head."""
    gen = torch.Generator().manual_seed(0)
    tg = tgan.generator_init(gen, device="cpu")
    ta = tvision.atrous_head_init(gen, device="cpu")
    key = jax.random.PRNGKey(0)
    for t, j in ((tg, jax.eval_shape(jgan.generator_init, key)),
                 (ta, jax.eval_shape(jvision.atrous_head_init, key))):
        assert set(t) == set(j)
        for k in t:
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert t[k].dtype == torch.float32
    fan_in = {"proj": 64, "t1": 16 * 64, "t2": 16 * 32, "t3": 16 * 3}
    for k, n in fan_in.items():
        scale = 1.0 / np.sqrt(n)
        assert float(tg[k].abs().max()) <= 2.0 * scale + 1e-6, k
        assert abs(float(tg[k].std()) / (_TRUNC_STD * scale) - 1) < 0.1, k
    for k, n in {"rate1": 27, "rate2": 27, "rate4": 27, "fuse": 48}.items():
        assert abs(float(ta[k].std()) * np.sqrt(n) - 1) < 0.2, k
    again = tgan.generator_init(torch.Generator().manual_seed(0),
                                device="cpu")
    assert all(torch.equal(tg[k], again[k]) for k in tg)


def test_params_from_numpy_copies_nested_trees():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(2, np.float32), (np.zeros(1, np.float32),)]}
    out = params_from_numpy(tree, device="cpu")
    assert torch.equal(out["a"], torch.tensor(tree["a"]))
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    tree["a"][0, 0] = 99.0
    assert out["a"][0, 0] == 0.0                 # a copy, not a view


# ---------------------------------------------------------------------------
# ConvServeEngine against repro's engine
# ---------------------------------------------------------------------------

def _requests(mod, rng, kinds, deadline_s=None):
    out = []
    for kind in kinds:
        shape = (Z_DIM,) if kind == "gan_gen" else IMG
        out.append(mod.ConvRequest(None, kind,
                                   rng.standard_normal(shape).astype(
                                       np.float32), deadline_s=deadline_s))
    return out


def _engines(gan_np, aspp_np, **kw):
    port_ladder = kw.pop("port_ladder", ("cuda",))
    repro_ladder = kw.pop("repro_ladder", ("xla_zero_free",))
    t = teng.ConvServeEngine(
        gan_params=params_from_numpy(gan_np, device="cpu"),
        aspp_params=params_from_numpy(aspp_np, device="cpu"),
        ladder=port_ladder, device="cpu", **kw)
    j = jeng.ConvServeEngine(gan_params=gan_np, aspp_params=aspp_np,
                             ladder=repro_ladder, **kw)
    return t, j


STAT_KEYS = ("submitted", "completed", "sheds", "failures", "retries",
             "fallbacks", "nan_events", "deadline_misses", "kernel_faults",
             "quarantines", "reprobes", "launches")


def test_engine_matches_repro_engine(gan_np, aspp_np):
    """Interleaved buckets, a full slot batch and a ragged one, a shed
    past the admission bound and a request already past its deadline:
    same results, same accounting."""
    t, j = _engines(gan_np, aspp_np, slot_batch=2, queue_limit=6)
    kinds = ["gan_gen", "aspp", "gan_gen", "aspp", "gan_gen"]
    t_reqs = _requests(teng, np.random.default_rng(2), kinds)
    j_reqs = _requests(jeng, np.random.default_rng(2), kinds)
    t_reqs += _requests(teng, np.random.default_rng(3), ["aspp"], 0.0)
    j_reqs += _requests(jeng, np.random.default_rng(3), ["aspp"], 0.0)
    t_reqs += _requests(teng, np.random.default_rng(4), ["gan_gen"])
    j_reqs += _requests(jeng, np.random.default_rng(4), ["gan_gen"])
    t_res, j_res = t.serve(t_reqs), j.serve(j_reqs)
    assert sorted(t_res) == sorted(j_res)
    for uid in j_res:
        assert_allclose(t_res[uid], j_res[uid], err_msg=str(uid))
    th, jh = t.health(), j.health()
    assert {k: th[k] for k in STAT_KEYS} == {k: jh[k] for k in STAT_KEYS}
    assert th["sheds"] == 1 and th["deadline_misses"] == 1
    assert th["queue_depth"] == jh["queue_depth"] == 0


class _Flaky:
    """A backend whose first `n` launches raise, then delegate to a good
    backend -- registered under the same name in both packages."""

    def __init__(self, spec_mod, good: str, n: int):
        self.left = n
        self.good = spec_mod.resolve_backend(good)

    def _gate(self):
        if self.left > 0:
            self.left -= 1
            raise RuntimeError("injected launch failure")

    def forward(self, *a):
        self._gate()
        return self.good.forward(*a)

    def input_grad(self, *a):
        self._gate()
        return self.good.input_grad(*a)

    def forward_ep(self, *a):
        self._gate()
        return self.good.forward_ep(*a)

    def input_grad_ep(self, *a):
        self._gate()
        return self.good.input_grad_ep(*a)

    def backend(self, spec_mod, name):
        return spec_mod.ConvBackend(
            name, self.forward, self.input_grad, self.good.filter_grad,
            fused_forward_ep=self.forward_ep,
            fused_input_grad_ep=self.input_grad_ep)


@pytest.mark.parametrize("failures,cooldown,expect", [
    (2, 2, [("closed", "open"), ("open", "half_open"),
            ("half_open", "closed")]),
    (3, 2, [("closed", "open"), ("open", "half_open"),
            ("half_open", "open")]),
])
def test_breaker_transitions_match_repro_engine(gan_np, aspp_np, failures,
                                                cooldown, expect):
    """A flaky first rung: the port's breaker walks the same transitions,
    with the same fault, fallback, quarantine and re-probe counts, as
    `repro`'s; every request is still answered, by the second rung."""
    name = f"test_flaky_{failures}_{cooldown}"
    tspec.register_backend(_Flaky(tspec, "torch_zero_free", failures)
                           .backend(tspec, name))
    jspec.register_backend(_Flaky(jspec, "xla_zero_free", failures)
                           .backend(jspec, name))
    t, j = _engines(gan_np, aspp_np, slot_batch=1, queue_limit=8,
                    fail_threshold=2, cooldown=cooldown,
                    port_ladder=(name, "cuda"),
                    repro_ladder=(name, "xla_zero_free"))
    kinds = ["gan_gen"] * 4
    t_res = t.serve(_requests(teng, np.random.default_rng(5), kinds))
    j_res = j.serve(_requests(jeng, np.random.default_rng(5), kinds))
    assert len(t_res) == len(j_res) == 4
    for uid in j_res:
        assert_allclose(t_res[uid], j_res[uid])
    t_br = t._buckets[("gan_gen", (Z_DIM,))].breakers[name]
    j_br = j._buckets[("gan_gen", (Z_DIM,))].breakers[name]
    assert t_br.transitions == j_br.transitions == expect
    th, jh = t.health(), j.health()
    assert {k: th[k] for k in STAT_KEYS} == {k: jh[k] for k in STAT_KEYS}


def test_breaker_unit_semantics_match_repro():
    script = ["f", "f", "a", "a", "a", "s", "f", "f", "a", "a", "a", "f",
              "a", "a", "a", "s"]
    seen = []
    for mod in (teng, jeng):
        br = mod.CircuitBreaker(fail_threshold=2, cooldown=3)
        trace = []
        for step in script:
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            else:
                trace.append(br.allow())
            trace.append(br.state)
        seen.append((trace, br.transitions))
    assert seen[0] == seen[1]
    with pytest.raises(ValueError):
        teng.CircuitBreaker(cooldown=0)


def test_engine_refuses_what_it_cannot_serve(gan_np, monkeypatch):
    """It refuses an empty ladder, a kind without params and an unknown
    kind, and a default device without a card.  An injector, refused
    before the fault rungs were ported, is taken."""
    params = params_from_numpy(gan_np, device="cpu")
    inj = tfaults.FaultInjector(tfaults.FaultSchedule())
    assert teng.ConvServeEngine(gan_params=params, device="cpu",
                                injector=inj).injector is inj
    with pytest.raises(ValueError):
        teng.ConvServeEngine(gan_params=params, device="cpu", ladder=())
    eng = teng.ConvServeEngine(gan_params=params, device="cpu")
    with pytest.raises(ValueError):
        eng._bucket("aspp", IMG)                 # no aspp params
    with pytest.raises(ValueError):
        eng._bucket("bogus", (1,))
    # No card: the default device raises instead of falling back.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.ConvServeEngine(gan_params=params)


def test_engine_on_the_card_serves_through_the_kernels_alone(monkeypatch):
    """On a CUDA device the default ladder is still the kernels' single
    rung; a ladder with plain rungs serves only when the caller names it
    (checked without a card: no params, so nothing is moved to the
    device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert teng.ConvServeEngine(device="cuda").ladder == teng.CARD_LADDER \
        == ("cuda",)
    for ladder in (teng.DEFAULT_LADDER, ("torch_zero_free",),
                   ("cuda", "reference")):
        eng = teng.ConvServeEngine(device="cuda", ladder=ladder)
        assert eng.ladder == ladder and eng.device.type == "cuda"
    assert teng.ConvServeEngine(device="cpu").ladder == teng.DEFAULT_LADDER


def test_engine_on_the_card_raises_a_kernel_fault(gan_np):
    """A fault of the `cuda` rung on the card propagates instead of being
    absorbed as a failed cohort; on the CPU the same fault is absorbed."""
    def fault(bucket, backend, batch):
        raise RuntimeError("injected launch failure")

    reqs = lambda: _requests(teng, np.random.default_rng(6), ["gan_gen"])
    eng = teng.ConvServeEngine(gan_params=params_from_numpy(gan_np, "cpu"),
                               device="cpu", ladder=("cuda",))
    eng._forward = fault
    assert eng.serve(reqs()) == {}
    assert eng.stats["kernel_faults"] == eng.stats["failures"] == 1
    eng = teng.ConvServeEngine(gan_params=params_from_numpy(gan_np, "cpu"),
                               device="cpu", ladder=("cuda",))
    eng._forward = fault
    eng.device = torch.device("cuda")        # as the card's engine sees it
    with pytest.raises(RuntimeError, match="injected"):
        eng.serve(reqs())
    assert eng.stats["kernel_faults"] == 1 and eng.stats["fallbacks"] == 0


def test_warmup_plans_and_runs_the_primary_rung(gan_np, aspp_np, tmp_path):
    t, _ = _engines(gan_np, aspp_np, slot_batch=2, queue_limit=4,
                    tile_cache_path=tmp_path / "absent.json")
    summary = t.warmup([("gan_gen", (Z_DIM,)), ("aspp", IMG)], compile=True)
    # no artifact: every launch planned analytically, none timed
    assert summary == {"buckets": 2, "plans": 3 + 4, "artifact": 0,
                       "analytical": 7}
    assert t.health()["warmup"] == summary
    b = t._bucket("aspp", IMG)
    assert [s.dilation for s in b.specs] == [(1, 1), (2, 2), (4, 4), (1, 1)]


@pytest.mark.parametrize("artifact", ["absent", "rows", "garbage"])
def test_warmup_summary_matches_repro(gan_np, aspp_np, tmp_path, artifact):
    """The same shapes and the same artifact file give `repro`'s summary.
    "rows": the file holds one measured `|st:auto` row per package for
    the generator's t3 (each package reads only its own key: `repro`'s
    names its TPU mode, the port's the Hopper target); "garbage": both
    warn and plan every launch analytically."""
    import warnings

    from repro.kernels import tiling as jtiling
    from repro_torch.kernels import tiling as ttiling
    from repro_torch.kernels.implicit_gemm import plan as ig_plan
    from repro_torch.serve.faults import corrupt_tile_cache

    path = tmp_path / "artifact.json"
    t, j = _engines(gan_np, aspp_np, slot_batch=2, queue_limit=4,
                    tile_cache_path=path)
    _, spec, xs, ds, ep = tgan.generator_plan_requests(
        params_from_numpy(gan_np, "cpu"), 2)[-1]
    if artifact != "absent":
        jkey = jtiling._cache_key(
            "input_grad", jspec.ConvSpec.make(stride=2, padding=1,
                                              filter_shape=4), xs, ds, 4,
            jtiling.DEFAULT_VMEM_BUDGET, True,
            jspec.Epilogue(activation="tanh"), "auto")
        tkey = ttiling._cache_key("input_grad", spec, xs, ds, ep, "auto")
        row = ig_plan(spec, xs[0], xs[1:3], ds[1:3], xs[3], ds[3])
        path.write_text(json.dumps({
            jkey: {"cin_tile": 3, "cout_tile": 4, "spatial_tile": 16,
                   "strategy": "implicit_gemm", "us": 5.0},
            tkey: dict(ttiling._row(row), strategy="implicit_gemm",
                       us=5.0)}))
    if artifact == "garbage":
        corrupt_tile_cache(path, "garbage")
    shapes = [("gan_gen", (Z_DIM,)), ("aspp", IMG)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = j.warmup(shapes)
        got = t.warmup(shapes)
    assert got == want
    assert got["artifact"] == (1 if artifact == "rows" else 0)


def test_cuda_backend_is_inference_only():
    """The name is kept from the serving slice, when the cuda backend
    refused inputs that require grad; gradients now flow through it (one
    fused backward launch per conv on the card, the plain versions here)
    and agree with the oracle backend's."""
    from repro_torch.core.conv import ecoflow_conv_transpose
    dy = torch.randn((1, 4, 4, 5), generator=torch.Generator().manual_seed(0))
    grads = {}
    for backend in ("cuda", "torch_zero_free"):
        w = torch.linspace(-1, 1, 4 * 4 * 3 * 5).reshape(4, 4, 3, 5) \
            .requires_grad_()
        d = dy.clone().requires_grad_()
        y = ecoflow_conv_transpose(d, w, 2, 1, backend=backend)
        y.square().sum().backward()
        grads[backend] = (d.grad, w.grad)
    for a, b in zip(grads["cuda"], grads["torch_zero_free"]):
        assert a is not None
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert ecoflow_conv_transpose(dy, w, 2, 1, backend="cuda").shape \
            == (1, 8, 8, 3)
    with pytest.raises(ValueError, match="inconsistent"):
        ecoflow_conv_transpose(dy, w, 2, 1, n_out=(12, 12), backend="cuda")


# ---------------------------------------------------------------------------
# Serving under injected faults against `repro`'s engine (its acceptance
# pins, tests/test_conv_serve.py): both engines on their default ladders,
# `repro`'s rungs mapped to the port's (pallas -> cuda, xla_zero_free ->
# torch_zero_free), and the same schedule in each package's site names.
# ---------------------------------------------------------------------------

RUNG = {"pallas": "cuda", "xla_zero_free": "torch_zero_free",
        "reference": "reference"}

# `repro`'s jitted launches depend only on the bucket, the rung and the
# params (shared by every engine here), so its engines share one cache:
# each Pallas rung compiles once for the module.
_REPRO_JIT: dict = {}


def _site(site: str) -> str:
    kind, rung = site.split(":")
    return f"{kind}:{RUNG[rung]}"


def _injectors(events=(), seeded=None):
    """(port, repro) injectors over the same schedule: explicit `events`
    as (repro site, index, kind[, magnitude]), or `seeded` =
    (seed, repro sites, kwargs) -- `FaultSchedule.seeded`'s draws depend
    only on the order of the sites, so the mapped sites replay it."""
    if seeded is not None:
        seed, sites, kw = seeded
        j = jfaults.FaultSchedule.seeded(seed, sites=sites, **kw)
        t = tfaults.FaultSchedule.seeded(
            seed, sites=[_site(s) for s in sites], **kw)
    else:
        j = jfaults.FaultSchedule([jfaults.FaultEvent(*e) for e in events])
        t = tfaults.FaultSchedule([
            tfaults.FaultEvent(_site(e[0]), *e[1:]) for e in events])
    return tfaults.FaultInjector(t), jfaults.FaultInjector(j)


def _fault_engines(gan_np, aspp_np, t_inj, j_inj, **kw):
    t, j = _engines(gan_np, aspp_np, port_ladder=teng.DEFAULT_LADDER,
                    repro_ladder=jeng.DEFAULT_LADDER, **kw)
    t.injector, j.injector = t_inj, j_inj
    j._jit_cache = _REPRO_JIT
    return t, j


def _assert_same_accounting(t, j, t_inj, j_inj):
    """`STAT_KEYS`, every breaker's transitions and state, and the fired
    events equal `repro`'s under the rung map."""
    th, jh = t.health(), j.health()
    assert {k: th[k] for k in STAT_KEYS} == {k: jh[k] for k in STAT_KEYS}
    assert th["breakers"] == {_site(k): v for k, v in jh["breakers"].items()}
    assert sorted(t._buckets) == sorted(j._buckets)
    for key, b in j._buckets.items():
        for rung, br in b.breakers.items():
            assert t._buckets[key].breakers[RUNG[rung]].transitions == \
                br.transitions, (key, rung)
    assert th["transitions"] == {
        f"{k[0]}:{RUNG[rung]}": list(br.transitions)
        for k, b in j._buckets.items() for rung, br in b.breakers.items()}
    assert [(e.site, e.index, e.kind) for e in t_inj.fired] == \
        [(_site(e.site), e.index, e.kind) for e in j_inj.fired]


def _serve_both(t, j, kinds, seed, **kw):
    t_reqs = _requests(teng, np.random.default_rng(seed), kinds, **kw)
    j_reqs = _requests(jeng, np.random.default_rng(seed), kinds, **kw)
    t_res, j_res = t.serve(t_reqs), j.serve(j_reqs)
    assert sorted(t_res) == sorted(j_res)
    for uid in j_res:
        assert np.all(np.isfinite(t_res[uid]))
        assert_allclose(t_res[uid], j_res[uid], err_msg=str(uid))
    return t_reqs, t_res


@pytest.mark.parametrize("kind", ["gan_gen", "aspp"])
def test_full_degradation_is_the_reference_rung(gan_np, aspp_np, kind):
    """Kernel exceptions on every rung but `reference` force each bucket
    down to it: every request answered, bit-equal to the port's
    `reference` rung on the same zero-padded batch, within 1e-4 of
    `repro`'s results, with `repro`'s accounting."""
    sites = [f"{kind}:pallas", f"{kind}:xla_zero_free"]
    t_inj, j_inj = _injectors(seeded=(5, sites, dict(
        rate=1.0, horizon=1024, kinds=("kernel_exception",))))
    t, j = _fault_engines(gan_np, aspp_np, t_inj, j_inj, slot_batch=3,
                          queue_limit=8)
    reqs, res = _serve_both(t, j, [kind] * 2, 7)
    assert len(res) == 2
    batch = np.zeros((3,) + reqs[0].payload.shape, np.float32)
    batch[:2] = np.stack([r.payload for r in reqs])
    want = t._forward(t._bucket(kind, batch.shape[1:]), "reference", batch)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(res[r.uid], want[i])
    h = t.health()
    assert h["kernel_faults"] == 2 and h["fallbacks"] == 1
    _assert_same_accounting(t, j, t_inj, j_inj)


def test_mixed_fault_storm_completes_all(gan_np, aspp_np, tmp_path):
    """Kernel exceptions and NaN outputs on the fast rungs (seed 13, rate
    0.4) and a corrupt tile-cache artifact: warmup warns and re-plans,
    every admitted request completes finite, and the stats, transitions
    and fired events are `repro`'s."""
    cache = tmp_path / "tile_cache.json"
    tfaults.corrupt_tile_cache(cache, "garbage")
    t_inj, j_inj = _injectors(seeded=(
        13, ["gan_gen:pallas", "gan_gen:xla_zero_free"],
        dict(rate=0.4, horizon=1024, kinds=("kernel_exception",
                                            "nan_output"))))
    t, j = _fault_engines(gan_np, aspp_np, t_inj, j_inj, slot_batch=2,
                          queue_limit=32, tile_cache_path=cache)
    for eng in (t, j):
        with pytest.warns(RuntimeWarning):
            summary = eng.warmup([("gan_gen", (Z_DIM,))])
        assert summary["analytical"] == summary["plans"] > 0
    _, res = _serve_both(t, j, ["gan_gen"] * 10, 8)
    assert len(res) == 10
    fired = {e.kind for e in t_inj.fired}
    assert fired == {"kernel_exception", "nan_output"}
    h = t.health()
    assert h["kernel_faults"] > 0 and h["nan_events"] > 0 \
        and h["fallbacks"] > 0
    _assert_same_accounting(t, j, t_inj, j_inj)


@pytest.mark.parametrize("events,expect", [
    # NaN twice on the first rung: one retry, then degrade.
    ([("gan_gen:pallas", 0, "nan_output"),
      ("gan_gen:pallas", 1, "nan_output")],
     dict(nan_events=2, retries=2, fallbacks=1)),
    # a transient NaN: the retry on the same rung serves.
    ([("gan_gen:pallas", 0, "inf_output")],
     dict(nan_events=1, retries=1, fallbacks=0)),
], ids=["retry_then_degrade", "transient_recovers"])
def test_nan_guard_matches_repro(gan_np, aspp_np, events, expect):
    t_inj, j_inj = _injectors(events)
    t, j = _fault_engines(gan_np, aspp_np, t_inj, j_inj, slot_batch=1,
                          queue_limit=4)
    _, res = _serve_both(t, j, ["gan_gen"], 9)
    assert len(res) == 1
    h = t.health()
    assert {k: h[k] for k in expect} == expect
    assert h["breakers"]["gan_gen:cuda"] == "closed"
    _assert_same_accounting(t, j, t_inj, j_inj)


@pytest.mark.parametrize("n_faults,expect", [
    (2, [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]),
    (3, [("closed", "open"), ("open", "half_open"), ("half_open", "open")]),
], ids=["reprobe_closes", "reprobe_reopens"])
def test_quarantine_then_reprobe_matches_repro(gan_np, aspp_np, n_faults,
                                               expect):
    """`cuda` raises on its first launches (threshold 2 -> OPEN);
    quarantined launches skip it; after the cooldown the breaker
    half-opens and the probe closes it, or re-opens it on a third
    fault."""
    t_inj, j_inj = _injectors([("gan_gen:pallas", i, "kernel_exception")
                               for i in range(n_faults)])
    t, j = _fault_engines(gan_np, aspp_np, t_inj, j_inj, slot_batch=1,
                          queue_limit=8, fail_threshold=2, cooldown=2)
    _, res = _serve_both(t, j, ["gan_gen"] * 4, 10)
    assert len(res) == 4
    assert t._buckets[("gan_gen", (Z_DIM,))].breakers["cuda"] \
        .transitions == expect
    h = t.health()
    assert h["quarantines"] == (1 if n_faults == 2 else 2)
    assert h["reprobes"] == 1
    assert t_inj.calls("gan_gen:cuda") == 3
    _assert_same_accounting(t, j, t_inj, j_inj)


def test_fully_open_ladder_still_answers(gan_np, aspp_np):
    """Every rung always raises: each launch is still tried on the last
    rung, and every failure is accounted, with no hang."""
    t_inj, j_inj = _injectors(seeded=(5, [
        "gan_gen:pallas", "gan_gen:xla_zero_free", "gan_gen:reference"],
        dict(rate=1.0, horizon=1024, kinds=("kernel_exception",))))
    t, j = _fault_engines(gan_np, aspp_np, t_inj, j_inj, slot_batch=1,
                          queue_limit=8, fail_threshold=1, cooldown=100)
    _serve_both(t, j, ["gan_gen"] * 3, 11)
    h = t.health()
    assert h["failures"] == 3 and h["launches"] == 3 and h["completed"] == 0
    _assert_same_accounting(t, j, t_inj, j_inj)


def test_latency_spike_misses_deadline(gan_np, aspp_np):
    """A straggler (an injected latency spike) pushes completion past the
    request's deadline: the result is withheld and counted as a miss."""
    t, j = _fault_engines(gan_np, aspp_np, None, None, slot_batch=1,
                          queue_limit=4)
    _serve_both(t, j, ["gan_gen"], 12)      # warm, outside the window
    t.injector, j.injector = _injectors(
        [("gan_gen:pallas", 0, "latency_spike", 0.3)])
    res = _serve_both(t, j, ["gan_gen"], 13, deadline_s=0.05)[1]
    assert res == {}
    h = t.health()
    assert h["deadline_misses"] == 1 and h["completed"] == 1
    _assert_same_accounting(t, j, t.injector, j.injector)


def _as_card(eng, fail_cuda=False, nan_cuda=False):
    """`eng` seen as the card's engine (`device` cuda) while its forward
    passes run here on the CPU; with `fail_cuda` the `cuda` rung raises a
    CUDA-style RuntimeError instead of running, with `nan_cuda` it
    returns NaN where no fault was injected (a kernel's own fault)."""
    real = eng._forward

    def forward(bucket, backend, batch):
        if fail_cuda and backend == "cuda":
            raise RuntimeError("CUDA error: unspecified launch failure")
        card, eng.device = eng.device, torch.device("cpu")
        try:
            out = real(bucket, backend, batch)
        finally:
            eng.device = card
        return np.full_like(out, np.nan) if nan_cuda and backend == "cuda" \
            else out

    eng._forward = forward
    eng.device = torch.device("cuda")
    return eng


def test_engine_on_the_card_degrades_only_on_injected_faults_and_nans(
        gan_np):
    """The card rule, with the device faked as the card's engine sees it:
    an injected kernel exception degrades, and so does a non-finite
    output after its retry; a `RuntimeError` of the rung propagates with
    no fallback.  On the CPU the same `RuntimeError` degrades."""
    params = params_from_numpy(gan_np, "cpu")
    reqs = lambda: _requests(teng, np.random.default_rng(14),  # noqa: E731
                             ["gan_gen"])
    for events, stats in (
            ([tfaults.FaultEvent("gan_gen:cuda", 0, "kernel_exception")],
             dict(kernel_faults=1, nan_events=0, fallbacks=1)),
            ([tfaults.FaultEvent("gan_gen:cuda", i, "nan_output")
              for i in (0, 1)],
             dict(kernel_faults=0, nan_events=2, fallbacks=1))):
        eng = _as_card(teng.ConvServeEngine(
            gan_params=params, device="cpu", ladder=teng.DEFAULT_LADDER,
            injector=tfaults.FaultInjector(tfaults.FaultSchedule(events))))
        res = eng.serve(reqs())
        assert len(res) == 1 and np.all(np.isfinite(*res.values()))
        assert {k: eng.stats[k] for k in stats} == stats

    eng = _as_card(teng.ConvServeEngine(gan_params=params, device="cpu",
                                        ladder=teng.DEFAULT_LADDER),
                   fail_cuda=True)
    with pytest.raises(RuntimeError, match="launch failure"):
        eng.serve(reqs())
    assert eng.stats["fallbacks"] == 0 and eng.stats["kernel_faults"] == 1
    eng = _as_card(teng.ConvServeEngine(gan_params=params, device="cpu",
                                        ladder=teng.DEFAULT_LADDER),
                   fail_cuda=True)
    eng.device = torch.device("cpu")
    assert len(eng.serve(reqs())) == 1 and eng.stats["fallbacks"] == 1


@pytest.mark.parametrize("case", ["kernel_nan", "nan_payload"])
def test_engine_on_the_card_raises_a_non_finite_kernel_output(gan_np, case):
    """The card rule for non-finite outputs, with the device faked: a NaN
    that the `cuda` rung returns from finite inputs with nothing injected
    is a kernel fault and raises with no fallback; a NaN payload is no
    kernel's fault, and walks the ladder to a failed cohort as on the
    CPU, with the same accounting."""
    params = params_from_numpy(gan_np, "cpu")
    reqs = _requests(teng, np.random.default_rng(16), ["gan_gen"])
    if case == "nan_payload":
        reqs[0].payload[0] = np.nan
    eng = _as_card(teng.ConvServeEngine(gan_params=params, device="cpu",
                                        ladder=teng.DEFAULT_LADDER),
                   nan_cuda=case == "kernel_nan")
    if case == "kernel_nan":
        with pytest.raises(RuntimeError, match="non-finite output of the "
                                               "'cuda' rung"):
            eng.serve(reqs)
        assert {k: eng.stats[k] for k in ("nan_events", "fallbacks",
                                          "retries", "completed")} == \
            dict(nan_events=1, fallbacks=0, retries=0, completed=0)
        return
    cpu = teng.ConvServeEngine(gan_params=params, device="cpu",
                               ladder=teng.DEFAULT_LADDER)
    assert eng.serve(reqs) == {} == cpu.serve(
        [teng.ConvRequest(None, r.kind, r.payload) for r in reqs])
    assert eng.health()["failures"] == 1 and eng.stats["nan_events"] == 6
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: cpu.stats[k] for k in STAT_KEYS}


def test_fuse_epilogue_off_matches_repro(gan_np, aspp_np):
    """`fuse_epilogue=False`: the activations run as separate ops, the
    plan entries carry no epilogue, and the results are `repro`'s."""
    t, j = _engines(gan_np, aspp_np, slot_batch=2, queue_limit=8,
                    fuse_epilogue=False)
    for kind, shape in (("gan_gen", (Z_DIM,)), ("aspp", IMG)):
        got = t._plan_entries(kind, shape)
        want = j._plan_entries(kind, shape)
        assert [(op, s.stride, s.padding, s.dilation, tuple(xs), tuple(ds),
                 ep) for op, s, xs, ds, ep in got] == \
            [(op, s.stride, s.padding, s.dilation, tuple(xs), tuple(ds),
              ep) for op, s, xs, ds, ep in want]
        assert all(e[-1] is None for e in got)
    _serve_both(t, j, ["gan_gen", "aspp", "gan_gen"], 15)
    fused, _ = _engines(gan_np, aspp_np, slot_batch=2, queue_limit=8)
    assert any(e[-1] is not None
               for e in fused._plan_entries("gan_gen", (Z_DIM,)))
