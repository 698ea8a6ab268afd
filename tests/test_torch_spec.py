"""`repro_torch.core.spec` against `repro.core.spec`: ConvSpec geometry and
tap-phase bookkeeping, the Epilogue descriptor, the backend registry and
the ConvBackend compositions.  Inputs come from numpy seeds; fp32 values
are compared at rtol = atol = 1e-4 (DESIGN.md Sec. 2.3)."""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.core import conv as jconv
from repro.core import ecoflow as jeco
from repro.core import spec as jspec
from repro_torch.core import conv as tconv
from repro_torch.core import ecoflow as teco
from repro_torch.core import spec as tspec

GRID = list(itertools.product((1, 2, 3), (1, 2, 3), (1, 2, 3, 4), (0, 1, 2)))
SIZES = [(1, 1), (4, 5), (7, 7), (16, 9)]


def _fields(spec):
    """Every field and derived size of a ConvSpec, as plain python."""
    s0, s1 = spec.stride
    out = {
        "stride": spec.stride, "padding": spec.padding,
        "filter_shape": spec.filter_shape, "dilation": spec.dilation,
        "dilated_filter_shape": spec.dilated_filter_shape,
        "n_phases": spec.n_phases,
        "packed_phase_shape": spec.packed_phase_shape,
        "useful_taps": spec.useful_taps(),
        "tap_phase_period": spec.tap_phase_period,
        "tap_phase_step": spec.tap_phase_step,
        "n_tap_phases": spec.n_tap_phases,
        "taps_per_phase": spec.taps_per_phase,
        "phase_index": [spec.phase_index(p, q) for p in range(s0)
                        for q in range(s1)],
        "phase_filter_shape": [spec.phase_filter_shape(p, q)
                               for p in range(s0) for q in range(s1)],
        "residue": [spec.tap_phase_residue(a, ax) for ax in (0, 1)
                    for a in range(spec.n_tap_phases[ax])],
        "base": [spec.tap_phase_base(a, ax) for ax in (0, 1)
                 for a in range(spec.n_tap_phases[ax])],
    }
    for n in SIZES:
        out[f"out_size{n}"] = spec.out_size(n)
        out[f"input_size{n}"] = spec.input_size(n)
        out[f"full_size{n}"] = spec.full_size(n)
    return out


@pytest.mark.parametrize("s,d,k,p", GRID)
def test_convspec_matches_repro(s, d, k, p):
    ts = tspec.ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    js = jspec.ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    assert _fields(ts) == _fields(js)
    for n in SIZES:
        o = js.out_size(n)
        if min(o) >= 1:
            assert teco.predicated_mac_fraction(ts, o) == \
                jeco.predicated_mac_fraction(js, o)


@pytest.mark.parametrize("kw", [
    dict(stride=(2, 3), padding=(1, 0), filter_shape=(4, 2), dilation=(1, 2)),
    dict(stride=[3, 1], padding=2, filter_shape=(3, 5), dilation=(2, 1)),
])
def test_convspec_anisotropic_matches_repro(kw):
    assert _fields(tspec.ConvSpec.make(**kw)) == \
        _fields(jspec.ConvSpec.make(**kw))


@pytest.mark.parametrize("bad", [dict(stride=0), dict(padding=-1),
                                 dict(filter_shape=0), dict(dilation=0),
                                 dict(stride=(1, 2, 3))])
def test_convspec_rejects_what_repro_rejects(bad):
    with pytest.raises(ValueError):
        jspec.ConvSpec.make(**bad)
    with pytest.raises(ValueError):
        tspec.ConvSpec.make(**bad)


EPILOGUES = [dict(), dict(activation="relu"), dict(bias=True),
             dict(activation="leaky_relu", slope=0.2, bias=True),
             dict(activation="tanh", scale=0.5),
             dict(activation="relu", bias=True, scale=-1.5)]


@pytest.mark.parametrize("kw", EPILOGUES)
def test_epilogue_matches_repro(kw):
    te, je = tspec.Epilogue(**kw), jspec.Epilogue(**kw)
    for attr in ("activation", "bias", "slope", "scale", "is_identity",
                 "needs_y", "tag"):
        assert getattr(te, attr) == getattr(je, attr), attr
    rng = np.random.default_rng(0)
    v = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32) if te.bias else None
    y_t = te.apply(torch.tensor(v), None if b is None else torch.tensor(b))
    y_j = je.apply(jnp.asarray(v), None if b is None else jnp.asarray(b))
    assert_allclose(y_t, y_j)
    m_t = te.mask_cotangent(y_t, torch.tensor(g))
    m_j = je.mask_cotangent(y_j, jnp.asarray(g))
    assert_allclose(m_t, m_j)


@pytest.mark.parametrize("kw", [dict(activation="gelu"),
                                dict(activation="leaky_relu", slope=0.0)])
def test_epilogue_rejects_what_repro_rejects(kw):
    with pytest.raises(ValueError):
        jspec.Epilogue(**kw)
    with pytest.raises(ValueError):
        tspec.Epilogue(**kw)
    with pytest.raises(ValueError):
        tspec.Epilogue(bias=True).apply(torch.zeros(3))


@pytest.mark.parametrize("ep_kw,with_bias", [
    (None, False), (None, True), (dict(), False), (dict(), True),
    (dict(activation="relu"), True), (dict(activation="tanh"), False)])
def test_normalize_epilogue_matches_repro(ep_kw, with_bias):
    t_ep = None if ep_kw is None else tspec.Epilogue(**ep_kw)
    j_ep = None if ep_kw is None else jspec.Epilogue(**ep_kw)
    t = tconv._normalize_epilogue(t_ep, torch.zeros(2) if with_bias
                                  else None)
    j = jconv._normalize_epilogue(j_ep, jnp.zeros(2) if with_bias else None)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.tag == j.tag
    with pytest.raises(ValueError):
        tconv._normalize_epilogue(tspec.Epilogue(bias=True), None)


def test_registry_resolves_names_and_refuses_unknown():
    assert set(tspec.available_backends()) >= {"reference",
                                                "torch_zero_free", "cuda"}
    assert tspec.resolve_backend(None).name == tspec.DEFAULT_BACKEND
    be = tspec.resolve_backend("cuda")
    assert tspec.resolve_backend(be) is be
    with pytest.raises(ValueError, match="unknown conv backend"):
        tspec.resolve_backend("pallas")
    # A tuple, refused before the ladder was ported, is `fallback_backend`'s
    # ladder (memoized); what designates no backend still raises.
    ladder = tspec.resolve_backend(("cuda", "reference"))
    assert ladder.name == "cuda>reference"
    assert tspec.resolve_backend(["cuda", "reference"]) is ladder
    with pytest.raises(TypeError):
        tspec.resolve_backend(1.5)


@pytest.mark.parametrize("name", ["reference", "torch_zero_free", "cuda"])
def test_backend_compositions_match_repro(name):
    """The generic *_ep compositions and the two-launch backward of every
    port backend against `repro`'s xla_zero_free on one strided, biased,
    leaky geometry (CPU tensors: the cuda backend's training slots run the
    torch_zero_free composition here)."""
    rng = np.random.default_rng(1)
    spec_kw = dict(stride=2, padding=1, filter_shape=3, dilation=1)
    ts, js = tspec.ConvSpec.make(**spec_kw), jspec.ConvSpec.make(**spec_kw)
    ep_kw = dict(activation="leaky_relu", slope=0.2, bias=True, scale=0.5)
    te, je = tspec.Epilogue(**ep_kw), jspec.Epilogue(**ep_kw)
    x = rng.standard_normal((2, 7, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    tb, jb = tspec.resolve_backend(name), jspec.resolve_backend(
        "xla_zero_free")
    y_t = tb.forward_ep(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                        ts, te)
    y_j = jb.forward_ep(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        js, je)
    assert_allclose(y_t, y_j)
    g = rng.standard_normal(y_j.shape).astype(np.float32)
    got = tb.backward_ep(torch.tensor(x), y_t, torch.tensor(g),
                         torch.tensor(w), ts, (7, 7), te)
    want = jb.backward_ep(jnp.asarray(x), y_j, jnp.asarray(g),
                          jnp.asarray(w), js, (7, 7), je)
    for a, b_ in zip(got, want):
        assert_allclose(a, b_)
    dy = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    zb = rng.standard_normal(3).astype(np.float32)
    z_t = tb.input_grad_ep(torch.tensor(dy), torch.tensor(w),
                           torch.tensor(zb), ts, (7, 7), te)
    z_j = jb.input_grad_ep(jnp.asarray(dy), jnp.asarray(w), jnp.asarray(zb),
                           js, (7, 7), je)
    assert_allclose(z_t, z_j)
    gz = rng.standard_normal(z_j.shape).astype(np.float32)
    got = tb.ct_backward_ep(torch.tensor(gz), z_t, torch.tensor(dy),
                            torch.tensor(w), ts, te)
    want = jb.ct_backward_ep(jnp.asarray(gz), z_j, jnp.asarray(dy),
                             jnp.asarray(w), js, je)
    for a, b_ in zip(got, want):
        assert_allclose(a, b_)
