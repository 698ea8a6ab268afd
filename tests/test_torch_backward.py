"""The port's backward on the CPU against `repro`: the plain versions of
the fused dual-gradient backwards and the filter gradient, and the
`torch.autograd.Function`s of `repro_torch.core.conv`.

  * The plain versions (what the `cuda` backend's wrappers run on CPU
    tensors) against `repro`'s Pallas kernels in interpret mode at three
    tiny geometries, then against `repro`'s `reference` backend over
    `test_backward_fused.BACKWARD_GRID` (copied to `_torch_cases` for
    the card's tests) under the four epilogues of
    `_torch_cases.EP_KW` (bias and scale included).
  * Each autograd Function, on each of the port's three backends, against
    `jax.vjp` of the matching `repro` entry point on `reference`.
  * `torch.autograd.gradcheck` in fp64 on `reference` and
    `torch_zero_free`.

Inputs come from numpy seeds.  Tolerance: fp32 at rtol = atol = 2e-4,
the bound `repro`'s own backward grid uses (dW sums over B*O*O products
in another order); fp64 gradcheck at its defaults.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (BACKWARD_GRID, EP_KW, backward_case,
                          epilogue_output)
from conftest import assert_allclose
from repro.core import conv as jconv
from repro.core import spec as jspec
from repro.kernels import ops as jops
from repro_torch.core import conv as tconv
from repro_torch.core import spec as tspec
from repro_torch.kernels import ops as tops
from test_backward_fused import BACKWARD_GRID as REPRO_BACKWARD_GRID

TOL = 2e-4
BACKENDS = ["cuda", "torch_zero_free", "reference"]


def _eps(kw):
    if kw is None:
        return None, None
    return tspec.Epilogue(**kw), jspec.Epilogue(**kw)


def _specs(c):
    S, P, K, D = c["spec"]
    kw = dict(stride=S, padding=P, filter_shape=K, dilation=D)
    return tspec.ConvSpec.make(**kw), jspec.ConvSpec.make(**kw)


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_backward_grid_is_repros():
    assert BACKWARD_GRID == REPRO_BACKWARD_GRID


# -- the plain versions against repro's Pallas kernels (interpret mode) ----

INTERPRET_GEOMS = [BACKWARD_GRID[2], BACKWARD_GRID[5], BACKWARD_GRID[8]]


@pytest.mark.parametrize("geom", INTERPRET_GEOMS, ids=lambda g: g[0])
def test_backward_plain_matches_pallas_interpret(geom):
    c = backward_case(geom, 1)
    ts, _ = _specs(c)
    kw = EP_KW[2]                          # leaky_relu + bias + scale
    te, je = _eps(kw)
    geo = dict(stride=ts.stride, padding=ts.padding, dilation=ts.dilation)
    y, z = epilogue_output(kw, c["y"]), epilogue_output(kw, c["z"])
    want = jops.conv_backward(_j(c["x"]), _j(c["dy"]), _j(c["w"]),
                              n_out=c["n"], y=_j(y), epilogue=je, **geo)
    got = tops.conv_backward(_t(c["x"]), _t(c["dy"]), _t(c["w"]),
                             n_out=c["n"], y=_t(y), epilogue=te, **geo)
    for a, b, name in zip(got, want, ("dx", "dW", "db")):
        assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
    want = jops.tconv_backward(_j(c["g"]), _j(c["dy"]), _j(c["w"]),
                               z=_j(z), epilogue=je, **geo)
    got = tops.tconv_backward(_t(c["g"]), _t(c["dy"]), _t(c["w"]),
                              z=_t(z), epilogue=te, **geo)
    for a, b, name in zip(got, want, ("ddy", "dW", "db")):
        assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
    assert_allclose(
        tops.dconv_filter_grad(_t(c["x"]), _t(c["dy"]),
                               k=ts.filter_shape, **geo),
        jops.dconv_filter_grad(_j(c["x"]), _j(c["dy"]), k=ts.filter_shape,
                               **geo), rtol=TOL, atol=TOL)


# -- the plain versions against repro's reference backend ------------------

@pytest.mark.parametrize("kw", EP_KW, ids=lambda k: "plain" if k is None
                         else jspec.Epilogue(**k).tag)
@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_conv_backward_plain_matches_reference(geom, kw):
    c = backward_case(geom, 2)
    ts, js = _specs(c)
    te, je = _eps(kw)
    ref = jspec.resolve_backend("reference")
    y = epilogue_output(kw, c["y"])
    geo = dict(stride=ts.stride, padding=ts.padding, dilation=ts.dilation,
               n_out=c["n"])
    got = tops.conv_backward(_t(c["x"]), _t(c["dy"]), _t(c["w"]),
                             y=_t(y), epilogue=te, **geo)
    if je is None:
        want = ref.backward(_j(c["x"]), _j(c["dy"]), _j(c["w"]), js, c["n"])
    else:
        want = ref.backward_ep(_j(c["x"]), _j(y), _j(c["dy"]), _j(c["w"]),
                               js, c["n"], je)
    assert len(got) == len(want)
    for a, b, name in zip(got, want, ("dx", "dW", "db")):
        if b is None:
            assert a is None, name
        else:
            assert tuple(a.shape) == tuple(b.shape), name
            assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("kw", EP_KW, ids=lambda k: "plain" if k is None
                         else jspec.Epilogue(**k).tag)
@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_tconv_backward_plain_matches_reference(geom, kw):
    c = backward_case(geom, 3)
    ts, js = _specs(c)
    te, je = _eps(kw)
    ref = jspec.resolve_backend("reference")
    z = epilogue_output(kw, c["z"])
    geo = dict(stride=ts.stride, padding=ts.padding, dilation=ts.dilation)
    got = tops.tconv_backward(_t(c["g"]), _t(c["dy"]), _t(c["w"]),
                              z=_t(z), epilogue=te, **geo)
    if je is None:
        want = ref.ct_backward(_j(c["g"]), _j(c["dy"]), _j(c["w"]), js)
    else:
        want = ref.ct_backward_ep(_j(c["g"]), _j(z), _j(c["dy"]),
                                  _j(c["w"]), js, je)
    assert len(got) == len(want)
    for a, b, name in zip(got, want, ("ddy", "dW", "db")):
        if b is None:
            assert a is None, name
        else:
            assert tuple(a.shape) == tuple(b.shape), name
            assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_filter_grad_plain_matches_reference(geom):
    c = backward_case(geom, 4)
    ts, js = _specs(c)
    got = tops.dconv_filter_grad(_t(c["x"]), _t(c["dy"]), stride=ts.stride,
                                 padding=ts.padding, k=ts.filter_shape,
                                 dilation=ts.dilation)
    want = jspec.resolve_backend("reference").filter_grad(
        _j(c["x"]), _j(c["dy"]), js)
    assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_backward_wrappers_refuse_bad_operands():
    c = backward_case(BACKWARD_GRID[0], 5)
    x, dy, w = _t(c["x"]), _t(c["dy"]), _t(c["w"])
    geo = dict(stride=1, padding=1, n_out=c["n"])
    relu = tspec.Epilogue(activation="relu")
    with pytest.raises(ValueError, match="residual y"):
        tops.conv_backward(x, dy, w, epilogue=relu, **geo)
    with pytest.raises(ValueError, match="does not map"):
        tops.conv_backward(x, dy, w[:, :, :2], **geo)
    with pytest.raises(ValueError, match="inconsistent"):
        tops.conv_backward(x, dy[:, 1:], w, **geo)
    with pytest.raises(TypeError, match="float32"):
        tops.dconv_filter_grad(x.double(), dy.double(), stride=1, padding=1,
                               k=3)
    with pytest.raises(ValueError, match="residual z"):
        tops.tconv_backward(_t(c["g"]), dy, w, stride=1, padding=1,
                            epilogue=relu)


# -- the autograd Functions against jax.vjp of repro's entry points --------

# (stride, padding, dilation, filter, batch, N, Cin, Cout)
VJP_GEOMS = [(2, 1, 1, 4, 2, 8, 3, 4),      # the GAN layers' geometry
             (2, 1, 1, 3, 2, 9, 4, 3),      # the CNN layers'
             (1, 2, 2, 3, 2, 7, 3, 2),      # atrous
             (3, 0, 2, 3, 1, 11, 2, 3)]     # coprime stride x dilation


def _vjp_case(geom, seed):
    s, p, d, k, B, N, ci, co = geom
    spec = tspec.ConvSpec.make(stride=s, padding=p, filter_shape=k,
                               dilation=d)
    O = spec.out_size((N, N))
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return spec, dict(x=r(B, N, N, ci), w=r(k, k, ci, co), dy=r(B, *O, co),
                      g_out=r(B, *O, co), g_in=r(B, N, N, ci),
                      b_out=r(co), b_in=r(ci))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw", EP_KW, ids=lambda k: "plain" if k is None
                         else jspec.Epilogue(**k).tag)
@pytest.mark.parametrize("geom", VJP_GEOMS, ids=str)
def test_conv_function_matches_jax_vjp(geom, kw, backend):
    _, c = _vjp_case(geom, 6)
    te, je = _eps(kw)
    bias = te is not None and te.bias
    s, p, d = geom[:3]
    args = [c["x"], c["w"]] + ([c["b_out"]] if bias else [])

    def jf(x, w, *b):
        return jconv.ecoflow_conv(x, w, s, p, "reference", d,
                                  bias=b[0] if b else None, epilogue=je)

    want_y, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(c["g_out"]))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got_y = tconv.ecoflow_conv(ts[0], ts[1], s, p, backend, d,
                               bias=ts[2] if bias else None, epilogue=te)
    got_y.backward(torch.tensor(c["g_out"]))
    assert_allclose(got_y.detach(), want_y, rtol=TOL, atol=TOL)
    for t, b in zip(ts, want):
        assert_allclose(t.grad, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw", EP_KW, ids=lambda k: "plain" if k is None
                         else jspec.Epilogue(**k).tag)
@pytest.mark.parametrize("geom", VJP_GEOMS, ids=str)
def test_conv_transpose_function_matches_jax_vjp(geom, kw, backend):
    _, c = _vjp_case(geom, 7)
    te, je = _eps(kw)
    bias = te is not None and te.bias
    s, p, d, _, _, N = geom[:6]
    args = [c["dy"], c["w"]] + ([c["b_in"]] if bias else [])

    def jf(dy, w, *b):
        return jconv.ecoflow_conv_transpose(dy, w, s, p, (N, N),
                                            "reference", d,
                                            bias=b[0] if b else None,
                                            epilogue=je)

    want_z, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(c["g_in"]))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got_z = tconv.ecoflow_conv_transpose(ts[0], ts[1], s, p, (N, N),
                                         backend, d,
                                         bias=ts[2] if bias else None,
                                         epilogue=te)
    got_z.backward(torch.tensor(c["g_in"]))
    assert_allclose(got_z.detach(), want_z, rtol=TOL, atol=TOL)
    for t, b in zip(ts, want):
        assert_allclose(t.grad, b, rtol=TOL, atol=TOL)


def test_functions_save_only_what_repro_saves():
    """(x, w) for a plain conv; the forward output joins them only when
    the epilogue's activation needs it for its mask."""
    x = torch.randn(1, 6, 6, 2, requires_grad=True)
    w = torch.randn(3, 3, 2, 3, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    y = tconv.ecoflow_conv(x, w, 1, 1, "cuda")
    assert len(y.grad_fn.saved_tensors) == 2
    y = tconv.ecoflow_conv(x, w, 1, 1, "cuda", bias=b)   # bias-add only
    assert [t is None for t in y.grad_fn.saved_tensors] == [False, False,
                                                            True]
    y = tconv.ecoflow_conv(x, w, 1, 1, "cuda",
                           epilogue=tspec.Epilogue(activation="relu"))
    assert torch.equal(y.grad_fn.saved_tensors[2], y)


# -- gradcheck in fp64 -----------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "torch_zero_free"])
@pytest.mark.parametrize("kw", [None, dict(activation="tanh", bias=True,
                                           scale=0.5),
                                dict(activation="leaky_relu", slope=0.2)],
                         ids=["plain", "tanh_bias_scale", "leaky"])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["conv", "conv_transpose"])
def test_functions_gradcheck_fp64(transposed, kw, backend):
    ep = None if kw is None else tspec.Epilogue(**kw)
    gen = torch.Generator().manual_seed(8)

    def r(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    w = r(3, 3, 2, 3)
    bias = [r(2 if transposed else 3)] if ep is not None and ep.bias else []
    if transposed:
        fn = lambda dy, w, *b: tconv.ecoflow_conv_transpose(  # noqa: E731
            dy, w, 2, 1, (7, 7), backend, 2, bias=b[0] if b else None,
            epilogue=ep)
        inp = r(1, 3, 3, 3)
    else:
        fn = lambda x, w, *b: tconv.ecoflow_conv(  # noqa: E731
            x, w, 2, 1, backend, 2, bias=b[0] if b else None, epilogue=ep)
        inp = r(1, 7, 7, 2)
    assert torch.autograd.gradcheck(fn, (inp, w, *bias))
