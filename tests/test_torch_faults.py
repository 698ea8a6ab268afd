"""`repro_torch.serve.faults` and the backend ladder against `repro`'s on
the same numpy inputs: `corrupt_tile_cache` (the same artifact mangled by
each mode and seed leaves the same bytes), `FaultSchedule.seeded` (the
same events with the sites mapped), `inject_backend`,
`core.spec.fallback_backend` -- alone and through one CNN step, one GAN
step and the atrous head's gradients -- and the ladder's card rule.
Tolerance: rtol = atol = 1e-4 (fp32 on both sides)."""
from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.core import spec as jspec
from repro.data import pipeline as jpipe
from repro.models import cnn as jcnn
from repro.models import gan as jgan
from repro.models import vision as jvision
from repro.serve import faults as jfaults
from repro_torch.convert import params_from_numpy
from repro_torch.core import spec as tspec
from repro_torch.models import cnn as tcnn
from repro_torch.models import gan as tgan
from repro_torch.models import vision as tvision
from repro_torch.models.layers import tree_map
from repro_torch.serve import faults as tfaults

ARTIFACT = {f"input_grad|b4|n8x8|row{i}": {"tile": i, "splits": 2 * i}
            for i in range(5)}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", ["truncate", "garbage", "torn_row"])
@pytest.mark.parametrize("start", ["artifact", "absent"])
def test_corrupt_tile_cache_writes_repros_bytes(tmp_path, mode, seed,
                                                start):
    paths = []
    for side, corrupt in (("repro", jfaults.corrupt_tile_cache),
                          ("port", tfaults.corrupt_tile_cache)):
        p = tmp_path / f"{side}.json"
        if start == "artifact":
            p.write_text(json.dumps(ARTIFACT, indent=2))
        corrupt(p, mode, seed=seed)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_corrupt_tile_cache_rejects_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="unknown corruption mode"):
        tfaults.corrupt_tile_cache(tmp_path / "c.json", "shred")


# ---------------------------------------------------------------------------
# The ladder (`core.spec.fallback_backend`) and `inject_backend` against
# `repro`'s, on the same numpy inputs: `repro`'s rungs mapped to the
# port's (pallas -> cuda, xla_zero_free -> torch_zero_free).
# ---------------------------------------------------------------------------

RUNG = {"pallas": "cuda", "xla_zero_free": "torch_zero_free",
        "reference": "reference"}


def _map_site(site: str) -> str:
    """A `repro` site (`<rung>.<op>`, `<kind>:<rung>`, `<rung>@inject`)
    in the port's rung names."""
    for sep in (":", ".", "@"):
        if sep in site:
            head, tail = site.split(sep, 1)
            if head in RUNG:
                return f"{RUNG[head]}{sep}{tail}"
            if tail in RUNG:
                return f"{head}{sep}{RUNG[tail]}"
    return RUNG.get(site, site)


def _fired(injector, mapped=False):
    return [(_map_site(e.site) if mapped else e.site, e.index, e.kind)
            for e in injector.fired]


def _always(mod, rung, kinds=("kernel_exception",), seed=3):
    """An injector whose every op of `rung` fires (rate 1)."""
    return mod.FaultInjector(mod.FaultSchedule.seeded(
        seed, sites=[f"{rung}.{op}" for op in tspec.OPS], rate=1.0,
        horizon=512, kinds=kinds))


def _geom(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 3), np.float32)
    w = rng.standard_normal((4, 4, 3, 5), np.float32)
    dy = rng.standard_normal((2, 4, 4, 5), np.float32)
    return x, w, dy


SPEC = dict(stride=2, padding=1, filter_shape=4)


@pytest.mark.parametrize("seed", [0, 5, 13, 29])
@pytest.mark.parametrize("kinds", [tfaults.FAULT_KINDS,
                                   ("kernel_exception", "nan_output")])
def test_seeded_schedules_are_repros_with_the_sites_mapped(seed, kinds):
    j_sites = ["gan_gen:pallas", "aspp:pallas", "gan_gen:xla_zero_free",
               "aspp:xla_zero_free", "xla_zero_free.forward"]
    kw = dict(rate=0.4, horizon=64, kinds=kinds, magnitude=0.25)
    want = jfaults.FaultSchedule.seeded(seed, sites=j_sites, **kw)
    got = tfaults.FaultSchedule.seeded(
        seed, sites=[_map_site(s) for s in j_sites], **kw)
    assert len(got) == len(want) > 0
    assert [(e.site, e.index, e.kind, e.magnitude) for e in got.events] == \
        [(_map_site(e.site), e.index, e.kind, e.magnitude)
         for e in want.events]


def test_fallback_backend_degrades_and_notifies():
    """A first rung that always raises: the ladder serves from
    `reference`, tells the observer each time, and `seen` is `repro`'s
    with the rungs mapped; the values are `repro`'s."""
    x, w, dy = _geom()
    got, want = {}, {}
    for side, spec_mod, fmod, first, conv in (
            ("port", tspec, tfaults, "torch_zero_free", torch.tensor),
            ("repro", jspec, jfaults, "xla_zero_free", jnp.asarray)):
        broken = fmod.inject_backend(first, _always(fmod, first))
        seen = []
        ladder = spec_mod.fallback_backend(
            (broken, "reference"),
            on_fallback=lambda name, op, exc: seen.append((name, op)))
        spec = spec_mod.ConvSpec.make(**SPEC)
        y = ladder.forward(conv(x), conv(w), spec)
        dx, dw = ladder.backward(conv(x), conv(dy), conv(w), spec, (8, 8))
        g = ladder.input_grad(conv(dy), conv(w), spec, (8, 8))
        (got if side == "port" else want).update(
            seen=seen, outs=[np.asarray(v) for v in (y, dx, dw, g)])
    assert got["seen"] == [(_map_site(n), op) for n, op in want["seen"]]
    assert got["seen"] == [("torch_zero_free@inject", op)
                           for op in ("forward", "backward", "input_grad")]
    for a, b in zip(got["outs"], want["outs"]):
        assert a.shape == b.shape
        assert_allclose(a, b)


def test_fused_backward_routes_through_a_rung_without_a_fused_kernel():
    """The `cuda` rung's fused slots fail; `reference` has no fused
    kernel, so its two-launch composition serves every fused op."""
    x, w, dy = _geom(1)
    x, w, dy = torch.tensor(x), torch.tensor(w), torch.tensor(dy)
    spec = tspec.ConvSpec.make(**SPEC)
    ep = tspec.Epilogue(activation="relu", bias=True)
    bias = torch.linspace(-1, 1, 5)
    ref = tspec.resolve_backend("reference")
    assert ref.fused_backward is None and ref.fused_backward_ep is None
    seen = []
    ladder = tspec.fallback_backend(
        (tfaults.inject_backend("cuda", _always(tfaults, "cuda")),
         "reference"), on_fallback=lambda n, op, e: seen.append(op))
    for a, b in zip(ladder.backward(x, dy, w, spec, (8, 8)),
                    (ref.input_grad(dy, w, spec, (8, 8)),
                     ref.filter_grad(x, dy, spec))):
        assert torch.equal(a, b)
    y = ref.forward_ep(x, w, bias, spec, ep)
    for a, b in zip(ladder.backward_ep(x, y, dy, w, spec, (8, 8), ep),
                    ref.backward_ep(x, y, dy, w, spec, (8, 8), ep)):
        assert torch.equal(a, b)
    for a, b in zip(ladder.ct_backward(x, dy, w, spec),
                    ref.ct_backward(x, dy, w, spec)):
        assert torch.equal(a, b)
    assert seen == ["backward", "backward_ep", "ct_backward"]


def test_fallback_backend_exhausted_reraises_and_refuses_an_empty_chain():
    x, w, _ = _geom()
    broken = tfaults.inject_backend("reference",
                                    _always(tfaults, "reference"))
    ladder = tspec.fallback_backend((broken,))
    with pytest.raises(tfaults.InjectedKernelFault):
        ladder.forward(torch.tensor(x), torch.tensor(w),
                       tspec.ConvSpec.make(**SPEC))
    with pytest.raises(ValueError, match="at least one"):
        tspec.fallback_backend(())
    with pytest.raises(ValueError, match="at least one"):
        tspec.resolve_backend([])


def test_resolve_backend_takes_a_tuple_memoized_and_the_legacy_bool():
    x, w, _ = _geom(2)
    a = tspec.resolve_backend(("cuda", "torch_zero_free", "reference"))
    b = tspec.resolve_backend(["cuda", "torch_zero_free", "reference"])
    assert a is b          # memoized: `_SHARDED_CACHE` keys on id(base)
    j = jspec.resolve_backend(("pallas", "xla_zero_free", "reference"))
    assert a.name == "cuda>torch_zero_free>reference" == \
        ">".join(RUNG[n] for n in j.name.split(">"))
    assert tspec.fallback_backend(("cuda", "reference"),
                                  on_fallback=print) is not \
        tspec.fallback_backend(("cuda", "reference"), on_fallback=print)
    # a chain holding a backend object is built afresh, never kept alive
    wrapped = tfaults.inject_backend("reference", _always(tfaults, "x"))
    n_memo = len(tspec._FALLBACK_CACHE)
    assert tspec.fallback_backend((wrapped, "reference")) is not \
        tspec.fallback_backend((wrapped, "reference"))
    assert len(tspec._FALLBACK_CACHE) == n_memo
    assert tspec.resolve_backend(True).name == "cuda"
    assert tspec.resolve_backend(False).name == "torch_zero_free"
    spec = tspec.ConvSpec.make(**SPEC)
    assert_allclose(a.forward(torch.tensor(x), torch.tensor(w), spec),
                    jspec.resolve_backend("reference").forward(
                        jnp.asarray(x), jnp.asarray(w),
                        jspec.ConvSpec.make(**SPEC)))
    with pytest.raises(TypeError):
        tspec.resolve_backend(3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["nan_output", "inf_output"])
def test_inject_backend_poisons_then_runs_clean(kind, dtype):
    """Output-class events poison every tensor the op returns, in place
    on its device and in its dtype, as `repro` poisons the host array;
    the next invocation is clean."""
    x, w, dy = _geom(3)
    spec = tspec.ConvSpec.make(**SPEC)
    inj = tfaults.FaultInjector(tfaults.FaultSchedule([
        tfaults.FaultEvent("reference.forward", 0, kind),
        tfaults.FaultEvent("reference.backward", 0, kind)]))
    be = tfaults.inject_backend("reference", inj)
    assert be.name == "reference@inject"
    xt, wt, dyt = (torch.tensor(a, dtype=dtype) for a in (x, w, dy))
    y = be.forward(xt, wt, spec)
    assert y.dtype == dtype and y.device == xt.device
    bad = torch.isnan if kind == "nan_output" else torch.isinf
    flat = y.reshape(y.shape[0], -1)
    assert bool(bad(flat[:, 0]).all()) and bool(flat[:, 1:].isfinite().all())
    j_inj = jfaults.FaultInjector(jfaults.FaultSchedule([
        jfaults.FaultEvent("reference.forward", 0, kind)]))
    want = np.asarray(jfaults.inject_backend("reference", j_inj).forward(
        jnp.asarray(x), jnp.asarray(w), jspec.ConvSpec.make(**SPEC)))
    if dtype == torch.float32:
        np.testing.assert_array_equal(np.isfinite(y.numpy()),
                                      np.isfinite(want))
    for t in be.backward(xt, dyt, wt, spec, (8, 8)):
        assert t.dtype == dtype and not bool(t.isfinite().all())
    assert bool(be.forward(xt, wt, spec).isfinite().all())   # clean
    assert _fired(inj) == [("reference.forward", 0, kind),
                           ("reference.backward", 0, kind)]
    v = torch.ones(5, dtype=dtype)
    p = tfaults.poison_tensor(inj.fired[0], v)
    assert p.shape == v.shape and bad(p[0]) and bool(v.isfinite().all())
    assert tfaults.poison_tensor(None, v) is v


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "cuda"])
def test_may_degrade_follows_the_card_rule(on_card):
    injected = tfaults.InjectedKernelFault("s", 0, "kernel_exception")
    lost = tfaults.InjectedDeviceLoss("s", 1, "device_loss")
    assert tspec.may_degrade(injected, on_card)
    assert tspec.may_degrade(lost, on_card)
    for exc in (RuntimeError("CUDA error: an illegal memory access"),
                TypeError("dtype refused"), ValueError("plan refused")):
        assert tspec.may_degrade(exc, on_card) is (not on_card)

    class Marked(RuntimeError):      # the mark `InjectedFault` carries
        injected = True

    assert tspec.may_degrade(Marked("x"), on_card)


class _CudaOperand(torch.Tensor):
    """A CPU tensor that reports itself on the card, to drive the
    ladder's card rule without one."""

    @property
    def is_cuda(self):
        return True


def test_fallback_backend_on_card_operands_degrades_only_on_injection():
    x, w, _ = _geom(4)
    spec = tspec.ConvSpec.make(**SPEC)

    def raising(*a):
        raise RuntimeError("CUDA error: unspecified launch failure")

    failing = tspec.ConvBackend("test_raises_runtime", raising, raising,
                                raising)
    injected = tfaults.inject_backend("torch_zero_free",
                                      _always(tfaults, "torch_zero_free"))
    xc = torch.tensor(x).as_subclass(_CudaOperand)
    wc = torch.tensor(w).as_subclass(_CudaOperand)
    for operands, on_card in (((torch.tensor(x), torch.tensor(w)), False),
                              ((xc, wc), True)):
        seen = []
        note = lambda n, op, e: seen.append(n)   # noqa: E731
        y = tspec.fallback_backend((injected, "reference"),
                                   on_fallback=note).forward(*operands, spec)
        assert seen == ["torch_zero_free@inject"]
        assert_allclose(y.as_subclass(torch.Tensor),
                        tspec.resolve_backend("reference").forward(
                            torch.tensor(x), torch.tensor(w), spec))
        seen.clear()
        ladder = tspec.fallback_backend((failing, "reference"),
                                        on_fallback=note)
        if on_card:
            with pytest.raises(RuntimeError, match="launch failure"):
                ladder.forward(*operands, spec)
            assert seen == []                  # no degradation
        else:
            ladder.forward(*operands, spec)
            assert seen == ["test_raises_runtime"]


# -- one training step through a ladder --------------------------------------

Z_DIM, BASE, BATCH = 8, 16, 2


def _repro_tree(init, seed, **kw):
    """A param tree in `repro`'s layout -- `init`'s keys and shapes, read
    with jax.eval_shape so nothing compiles -- filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)


@functools.lru_cache(maxsize=None)
def _repro_states():
    return (_repro_tree(jgan.gan_init, 0, z_dim=Z_DIM, base=BASE),
            _repro_tree(jcnn.simple_cnn_init, 1, widths=(4, 8, 16)),
            _repro_tree(jvision.atrous_head_init, 2, width=4))


def _step(side, which, backend):
    gan_np, cnn_np, aspp_np = _repro_states()
    if which == "atrous":    # the loss and its gradients
        rng = np.random.default_rng(6)
        x = rng.standard_normal((BATCH, 8, 8, 3)).astype(np.float32)
        y = rng.integers(0, 4, (BATCH, 8, 8)).astype(np.int32)
        if side == "port":
            p = params_from_numpy(aspp_np, "cpu")
            for t in p.values():
                t.requires_grad_()
            loss = tvision.atrous_seg_loss(p, torch.tensor(x),
                                           torch.tensor(y), backend=backend)
            grads = torch.autograd.grad(loss, list(p.values()))
            return [loss], dict(zip(p, grads))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jvision.atrous_seg_loss(p, x, y, backend=backend)))(
                aspp_np)
        return [loss], grads
    if which == "sgd_step":
        b = jpipe.ConvDataset(kind="cnn", batch=BATCH, image=12,
                              seed=4).batch_at(2)
        if side == "port":
            new, loss = tcnn.sgd_step(params_from_numpy(cnn_np, "cpu"),
                                      torch.tensor(b["x"]),
                                      torch.tensor(b["labels"]),
                                      backend=backend)
            return [loss], new
        new, loss = jax.jit(lambda p, x, y: jcnn.sgd_step(
            p, x, y, backend=backend))(cnn_np, b["x"], b["labels"])
        return [loss], new
    b = jpipe.ConvDataset(kind="gan", batch=BATCH, z_dim=Z_DIM,
                          seed=3).batch_at(5)
    if side == "port":
        new, g, d = tgan.gan_sgd_step(params_from_numpy(gan_np, "cpu"),
                                      torch.tensor(b["z"]),
                                      torch.tensor(b["real"]),
                                      backend=backend)
        return [g, d], new
    new, g, d = jax.jit(lambda st, z, r: jgan.gan_sgd_step(
        st, z, r, backend=backend))(gan_np, b["z"], b["real"])
    return [g, d], new


def _leaves(side, tree):
    if side == "port":
        tree = tree_map(lambda t: t.detach().numpy(), tree)
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("which", ["sgd_step", "gan_sgd_step", "atrous"])
def test_training_step_through_a_ladder(which):
    """The first rung (`cuda` / `pallas`) raises at every op, so every
    conv of the step (the atrous head's loss and gradients) -- forwards
    and fused backwards, through the four autograd Functions -- is
    served by the
    second: bit for bit the step on that rung alone, and `repro`'s step
    through its mapped ladder (jitted: its rungs raise at trace time)
    within 1e-4, with the same faults fired."""
    t_inj = _always(tfaults, "cuda")
    j_inj = _always(jfaults, "pallas")
    t_ladder = (tfaults.inject_backend("cuda", t_inj), "torch_zero_free")
    j_ladder = (jfaults.inject_backend("pallas", j_inj), "xla_zero_free")
    got_losses, got = _step("port", which, t_ladder)
    plain_losses, plain = _step("port", which, "torch_zero_free")
    want_losses, want = _step("repro", which, j_ladder)
    assert len(t_inj.fired) > 0
    assert _fired(t_inj) == _fired(j_inj, mapped=True)
    for a, b in zip(got_losses, plain_losses):
        assert torch.equal(a, b)
    for a, b in zip(got_losses, want_losses):
        assert_allclose(a.detach(), b)
    for a, b, c in zip(_leaves("port", got), _leaves("port", plain),
                       _leaves("repro", want)):
        np.testing.assert_array_equal(a, b)
        assert_allclose(a, c)
