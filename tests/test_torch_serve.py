"""The port's serving slice on the CPU against `repro`: the GAN generator
and the ASPP head from `repro`'s own params (through
`convert.params_from_numpy`), and `ConvServeEngine` against `repro`'s
engine on the same requests -- results, sheds, deadline misses and
circuit-breaker transitions.  Narrow widths; fp32 at rtol = atol = 1e-4
(DESIGN.md Sec. 2.3)."""
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
from repro_torch.convert import params_from_numpy
from repro_torch.core import spec as tspec
from repro_torch.models import gan as tgan
from repro_torch.models import vision as tvision
from repro_torch.serve import conv_engine as teng

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
    params = params_from_numpy(gan_np, device="cpu")
    with pytest.raises(NotImplementedError, match="injector"):
        teng.ConvServeEngine(gan_params=params, device="cpu",
                             injector=object())
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
    """On a CUDA device the default ladder is the kernels' single rung and
    a ladder with plain rungs is refused (checked without a card: no
    params, so nothing is moved to the device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert teng.ConvServeEngine(device="cuda").ladder == ("cuda",)
    for ladder in (teng.DEFAULT_LADDER, ("torch_zero_free",),
                   ("cuda", "reference")):
        with pytest.raises(ValueError, match="kernels alone"):
            teng.ConvServeEngine(device="cuda", ladder=ladder)
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
