"""The port's conv kernels in bf16 on the CPU against `repro`.

Every one of `repro`'s six conv kernels takes bf16 operands, sums in fp32
and casts back to the operand dtype; so does each wrapper of
`repro_torch.kernels.ops` on the card (its `_bf16` C entry) and, on CPU
tensors, its plain version, which widens the operands to fp32 and rounds
its output once.  Here the plain versions in bf16 are held against
`repro` on the same numpy inputs at 5e-2 (`repro`'s own bf16 class,
tests/test_kernels.py): at the geometries of `repro`'s bf16 tests, its
Pallas kernels run in interpret mode on one small case each, the
six-epilogue grid of tests/test_epilogue.py (value and every gradient,
against `repro`'s `pallas` backend), and the paper's CNN and GAN
steps with every param and the batch cast to bf16 (loss and every param
within 5e-2 of each leaf's largest magnitude, against `repro`'s steps on
`xla_zero_free`: its `reference` backend refuses a bf16 CNN step, see
ROADMAP.md C).  The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.core import conv as jconv
from repro.core import ecoflow as jecoflow
from repro.core import spec as jspec
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.kernels.dconv_backward import (conv_backward_pallas,
                                          tconv_backward_pallas)
from repro.kernels.dconv_filtergrad import dconv_filter_grad_pallas
from repro.kernels.dconv_forward import dconv_forward_pallas
from repro.kernels.implicit_gemm import tconv_implicit_gemm_pallas
from repro.kernels.tconv_phase import tconv_fused_pallas
from repro.models import cnn as jcnn
from repro.models import gan as jgan
from repro_torch.convert import params_from_numpy
from repro_torch.core import conv as tconv
from repro_torch.core import spec as tspec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn
from repro_torch.models import gan as tgan
from repro_torch.models import layers as tlayers

TOL = 5e-2
BF16 = torch.bfloat16
Z_DIM, BASE, BATCH = 8, 16, 4
CNN_WIDTHS, IMAGE = (4, 8, 16), 12


def _inputs(seed, *shapes):
    """Normal numpy arrays, one per shape, rounded to bf16's grid, so both
    frameworks read the same bf16 values."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.normal(size=s), jnp.bfloat16)
                       .astype(jnp.float32)) for s in shapes]


def _t(a):
    return torch.tensor(a).to(BF16)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))


def _hold(got, want, err_msg="", rel=False):
    """A bf16 output of the port against `repro`'s bf16 output: rtol 5e-2
    and atol 5e-2 (of the larger of 1 and want's largest magnitude with
    `rel`, for sums over many positions)."""
    assert got.dtype == BF16, err_msg
    assert want.dtype == jnp.bfloat16, err_msg
    a, b = _np(got), _np(want)
    assert a.shape == b.shape, err_msg
    atol = TOL * max(1.0, float(np.abs(b).max())) if rel else TOL
    assert_allclose(a, b, rtol=TOL, atol=atol, err_msg=err_msg)


# -- repro's own bf16 geometries, through each wrapper's plain version --------

def test_tconv_phase_bf16_geometry():
    """tests/test_kernels.py::test_tconv_phase_dtypes, bf16."""
    B, O, K, S, Ci, Co = 2, 5, 3, 2, 4, 6
    N = S * (O - 1) + K
    dy, w = _inputs(0, (B, O, O, Co), (K, K, Ci, Co))
    kw = dict(stride=(S, S), padding=(0, 0), n_out=(N, N))
    want = jref.tconv_phase_ref(_j(dy), _j(w), **kw)
    for strategy in ("phase", "implicit_gemm"):
        got = tops.tconv_phase(_t(dy), _t(w), strategy=strategy, **kw)
        _hold(got, want, strategy)


def test_dconv_filter_grad_bf16_geometry():
    """tests/test_kernels.py::test_dconv_filtergrad_bf16."""
    B, N, K, S, Ci, Co = 2, 9, 3, 2, 4, 4
    O = (N - K) // S + 1
    x, dy = _inputs(1, (B, N, N, Ci), (B, O, O, Co))
    want = jref.dconv_filter_grad_ref(_j(x), _j(dy), stride=(S, S),
                                      padding=(0, 0), k=(K, K))
    got = tops.dconv_filter_grad(_t(x), _t(dy), stride=(S, S),
                                 padding=(0, 0), k=(K, K))
    _hold(got, want)


def test_dconv_forward_bf16_geometry():
    """tests/test_kernels.py::test_dconv_forward_bf16 (D = 2)."""
    B, N, K, D, Ci, Co = 1, 11, 3, 2, 4, 4
    x, w = _inputs(2, (B, N, N, Ci), (K, K, Ci, Co))
    kw = dict(stride=(1, 1), padding=(2, 2), dilation=(2, 2))
    want = jref.dconv_forward_ref(_j(x), _j(w), **kw)
    _hold(tops.dconv_forward(_t(x), _t(w), **kw), want)


def test_conv_backward_bf16_geometry():
    """tests/test_backward_fused.py::test_fused_backward_bf16: dx and dW
    of one fused launch against the oracles."""
    B, N, K, S, Ci, Co = 2, 9, 3, 2, 4, 4
    O = (N - K) // S + 1
    x, w, dy = _inputs(3, (B, N, N, Ci), (K, K, Ci, Co), (B, O, O, Co))
    dx, dw = tops.conv_backward(_t(x), _t(dy), _t(w), stride=(S, S),
                                padding=(0, 0), n_out=(N, N))
    _hold(dx, jref.tconv_phase_ref(_j(dy), _j(w), stride=(S, S),
                                   padding=(0, 0), n_out=(N, N)), "dx")
    _hold(dw, jref.dconv_filter_grad_ref(_j(x), _j(dy), stride=(S, S),
                                         padding=(0, 0), k=(K, K)), "dW")


def test_tconv_implicit_gemm_bf16_geometry():
    """tests/test_implicit_gemm.py::test_bf16_output_dtype."""
    dy, w = _inputs(11, (1, 4, 4, 4), (3, 3, 4, 4))
    kw = dict(stride=(2, 2), padding=(1, 1), n_out=(7, 7))
    want = tconv_fused_pallas(_j(dy), _j(w), interpret=True, **kw)
    _hold(tops.tconv_implicit_gemm(_t(dy), _t(w), **kw), want)


def test_dilated_conv_bf16_geometry():
    """tests/test_dilated_parity.py::test_dilated_conv_bf16: the atrous
    forward (S 1, P 2, D 2) on the cuda backend against repro's dense
    direct conv."""
    x, w = _inputs(4, (3, 9, 9, 4), (3, 3, 4, 4))
    want = jecoflow.direct_conv(_j(x), _j(w), 1, 2, dilation=2)
    got = tconv.ecoflow_dilated_conv(_t(x), _t(w), 1, 2, 2, "cuda")
    _hold(got, want)


# -- one small case per Pallas kernel, in interpret mode ----------------------

_PALLAS_EP = dict(activation="leaky_relu", slope=0.2, bias=True, scale=0.5)


def _pallas_case(kernel):
    """(port outputs, repro's Pallas outputs in interpret mode) of one
    small bf16 case of `kernel`, with a bias / leaky / scale epilogue
    where the kernel takes one."""
    te, je = tspec.Epilogue(**_PALLAS_EP), jspec.Epilogue(**_PALLAS_EP)
    S, P = (2, 2), (1, 1)
    if kernel in ("tconv_phase", "tconv_implicit_gemm"):
        dy, w, b = _inputs(5, (2, 4, 4, 6), (3, 3, 5, 6), (5,))
        kw = dict(stride=S, padding=P, n_out=(8, 8))
        pallas = tconv_fused_pallas if kernel == "tconv_phase" \
            else tconv_implicit_gemm_pallas
        return (tops.tconv_phase(_t(dy), _t(w), bias=_t(b), epilogue=te,
                                 strategy="phase" if kernel == "tconv_phase"
                                 else "implicit_gemm", **kw),
                pallas(_j(dy), _j(w), bias=_j(b), epilogue=je,
                       interpret=True, **kw))
    if kernel == "dconv_forward":
        x, w, b = _inputs(6, (2, 9, 9, 5), (3, 3, 5, 6), (6,))
        kw = dict(stride=(1, 1), padding=(2, 2), dilation=(2, 2))
        return (tops.dconv_forward(_t(x), _t(w), bias=_t(b), epilogue=te,
                                   **kw),
                dconv_forward_pallas(_j(x), _j(w), bias=_j(b), epilogue=je,
                                     interpret=True, **kw))
    if kernel == "dconv_filter_grad":
        x, dy = _inputs(7, (2, 9, 9, 5), (2, 5, 5, 6))
        kw = dict(stride=S, padding=P, k=(3, 3))
        return (tops.dconv_filter_grad(_t(x), _t(dy), **kw),
                dconv_filter_grad_pallas(_j(x), _j(dy), interpret=True,
                                         **kw))
    if kernel == "conv_backward":
        x, w, dy, yr = _inputs(8, (2, 9, 9, 5), (3, 3, 5, 6), (2, 5, 5, 6),
                               (2, 5, 5, 6))
        y = np.where(yr > 0, yr, 0.2 * yr)
        kw = dict(stride=S, padding=P, n_out=(9, 9))
        return (tops.conv_backward(_t(x), _t(dy), _t(w), y=_t(y),
                                   epilogue=te, **kw),
                conv_backward_pallas(_j(x), _j(dy), _j(w), y=_j(y),
                                     epilogue=je, interpret=True, **kw))
    g, zr, dy, w = _inputs(9, (2, 8, 8, 5), (2, 8, 8, 5), (2, 4, 4, 6),
                           (3, 3, 5, 6))
    z = np.where(zr > 0, zr, 0.2 * zr)
    kw = dict(stride=S, padding=P)
    return (tops.tconv_backward(_t(g), _t(dy), _t(w), z=_t(z), epilogue=te,
                                **kw),
            tconv_backward_pallas(_j(g), _j(dy), _j(w), z=_j(z),
                                  epilogue=je, interpret=True, **kw))


@pytest.mark.parametrize("kernel", ["dconv_forward", "tconv_phase",
                                    "tconv_implicit_gemm", "conv_backward",
                                    "tconv_backward", "dconv_filter_grad"])
def test_plain_bf16_matches_repro_pallas_interpret(kernel):
    got, want = _pallas_case(kernel)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _hold(a, b, f"{kernel} output {i}", rel=True)


# -- the six-epilogue grid, value and every gradient --------------------------

_EPILOGUES = [
    ("bias", dict(bias=True)),
    ("relu", dict(activation="relu")),
    ("bias_relu", dict(activation="relu", bias=True)),
    ("bias_leaky02", dict(activation="leaky_relu", slope=0.2, bias=True)),
    ("tanh", dict(activation="tanh")),
    ("scaled_bias_relu", dict(activation="relu", bias=True, scale=0.5)),
]


def _epilogue_case(op, kw, seed):
    """Value and gradients of sum(sin(out)) of a bf16 conv (op "conv", x
    (2, 9, 9, 5), w (3, 3, 5, 7), stride 2, pad 1) or transposed conv (op
    "tconv", dy (2, 5, 5, 8), w (4, 4, 6, 8) -> (10, 10)), the port's
    cuda backend (plain versions) and repro's pallas backend (interpret
    mode), each with its epilogue fused: ((value, grads), (value,
    grads)).  Both apply the epilogue to the fp32 sum and round once, as
    the kernels do; `xla_zero_free` rounds the conv before its bias add,
    which can turn a relu mask where the sum is within one bf16 ulp of
    -bias."""
    te, je = tspec.Epilogue(**kw), jspec.Epilogue(**kw)
    if op == "conv":
        a, w, b = _inputs(seed, (2, 9, 9, 5), (3, 3, 5, 7), (7,))

        def t_fn(a_, w_, b_):
            return tconv.ecoflow_conv(a_, w_, 2, 1, "cuda", bias=b_,
                                      epilogue=te)

        def j_fn(a_, w_, b_):
            return jconv.ecoflow_conv(a_, w_, 2, 1, "pallas", bias=b_,
                                      epilogue=je)
    else:
        a, w, b = _inputs(seed, (2, 5, 5, 8), (4, 4, 6, 8), (6,))

        def t_fn(a_, w_, b_):
            return tconv.ecoflow_conv_transpose(a_, w_, 2, 1, (10, 10),
                                                "cuda", bias=b_, epilogue=te)

        def j_fn(a_, w_, b_):
            return jconv.ecoflow_conv_transpose(a_, w_, 2, 1, (10, 10),
                                                "pallas", bias=b_,
                                                epilogue=je)
    args = [a, w] + ([b] if te.bias else [])
    leaves = [_t(v).requires_grad_() for v in args]
    out = t_fn(*leaves, *([None] if not te.bias else []))
    grads = torch.autograd.grad(torch.sin(out.float()).sum(), leaves)

    def j_loss(*xs):
        return jnp.sum(jnp.sin(j_fn(*xs, *([None] if not je.bias else []))
                               .astype(jnp.float32)))
    jargs = [_j(v) for v in args]
    jgrads = jax.grad(j_loss, tuple(range(len(jargs))))(*jargs)
    return (out.detach(), grads), (j_fn(*jargs, *([None] if not je.bias
                                                  else [])), jgrads)


@pytest.mark.parametrize("op", ["conv", "tconv"])
@pytest.mark.parametrize("kind,kw", _EPILOGUES, ids=[k for k, _ in _EPILOGUES])
def test_epilogue_grid_bf16_matches_repro(op, kind, kw):
    (out, grads), (want, want_grads) = _epilogue_case(op, kw, 12)
    _hold(out, want, f"{op} {kind} value", rel=True)
    names = ("dx" if op == "conv" else "ddy", "dW", "db")
    for name, a, b in zip(names, grads, want_grads):
        _hold(a, b, f"{op} {kind} {name}", rel=True)


# -- the paper's steps in bf16 -----------------------------------------------

def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  tree)


def _port_tree(tree):
    """repro's bf16 tree as the port's: each leaf's bf16 values, cast leaf
    by leaf."""
    return tlayers.tree_map(
        lambda t: t.to(BF16),
        params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), tree), "cpu"))


def _hold_tree(got, want, err_msg):
    got_leaves = jax.tree_util.tree_leaves(
        tlayers.tree_map(lambda t: t, got),
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (a, b) in enumerate(zip(got_leaves, want_leaves)):
        _hold(a, b, f"{err_msg} leaf {i}", rel=True)


@functools.lru_cache(maxsize=None)
def _gan_state():
    return _bf16_tree(jgan.gan_init(jax.random.PRNGKey(0), z_dim=Z_DIM,
                                    base=BASE))


@functools.lru_cache(maxsize=None)
def _cnn_params():
    return _bf16_tree(jcnn.simple_cnn_init(jax.random.PRNGKey(1),
                                           widths=CNN_WIDTHS))


def _batch(kind):
    b = jpipe.ConvDataset(kind=kind, batch=BATCH, image=IMAGE, z_dim=Z_DIM,
                          seed=3).batch_at(1)
    return {k: v for k, v in b.items()}


def _x(a):
    """A ConvDataset array for both: floats cast to bf16, labels as they
    are."""
    if a.dtype.kind == "f":
        return _j(a), _t(a)
    return jnp.asarray(a), torch.tensor(a)


def test_sgd_step_bf16_matches_repro():
    (jx, tx), (jl, tl) = (_x(v) for v in (_batch("cnn")["x"],
                                          _batch("cnn")["labels"]))
    want, want_loss = jcnn.sgd_step(_cnn_params(), jx, jl,
                                    backend="xla_zero_free")
    got, loss = tcnn.sgd_step(_port_tree(_cnn_params()), tx, tl,
                              backend="cuda", fuse_epilogue=True)
    _hold(loss, want_loss, "loss", rel=True)
    _hold_tree(got, want, "sgd_step")


def test_gen_sgd_step_bf16_matches_repro():
    jz, tz = _x(_batch("gan")["z"])
    st = _gan_state()
    want, want_loss = jgan.gen_sgd_step(st["g"], st["d"], jz,
                                        backend="xla_zero_free")
    pst = _port_tree(st)
    got, loss = tgan.gen_sgd_step(pst["g"], pst["d"], tz, backend="cuda",
                                  fuse_epilogue=True)
    _hold(loss, want_loss, "g loss", rel=True)
    _hold_tree(got, want, "gen_sgd_step")


def test_gan_sgd_step_bf16_matches_repro():
    b = _batch("gan")
    (jz, tz), (jr, tr) = _x(b["z"]), _x(b["real"])
    want, want_g, want_d = jgan.gan_sgd_step(_gan_state(), jz, jr,
                                             backend="xla_zero_free")
    got, g_loss, d_loss = tgan.gan_sgd_step(_port_tree(_gan_state()), tz,
                                            tr, backend="cuda",
                                            fuse_epilogue=True)
    _hold(g_loss, want_g, "g loss", rel=True)
    _hold(d_loss, want_d, "d loss", rel=True)
    _hold_tree(got, want, "gan_sgd_step")


# -- the filter gradient's oracle ---------------------------------------------

@pytest.mark.parametrize("geom", [
    # (B, N, K, S, P, D, Cin, Cout)
    (2, 9, 3, 2, 0, 1, 4, 4),
    (1, 12, 3, 1, 2, 2, 3, 5),
    (2, 11, 2, 3, 1, 1, 5, 3),
])
def test_dconv_filter_grad_ref_matches_repro(geom):
    """The port's `ref.dconv_filter_grad_ref` against `repro`'s on fp32
    inputs, and the filter-gradient wrapper's plain version against it."""
    B, N, K, S, P, D, Ci, Co = geom
    spec = tspec.ConvSpec.make(stride=S, padding=P, filter_shape=K,
                               dilation=D)
    O = spec.out_size((N, N))
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, N, N, Ci)).astype(np.float32)
    dy = rng.normal(size=(B, *O, Co)).astype(np.float32)
    kw = dict(stride=(S, S), padding=(P, P), k=(K, K), dilation=(D, D))
    got = tref.dconv_filter_grad_ref(torch.tensor(x), torch.tensor(dy), **kw)
    want = jref.dconv_filter_grad_ref(jnp.asarray(x), jnp.asarray(dy), **kw)
    assert_allclose(got, want)
    assert_allclose(tops.dconv_filter_grad(torch.tensor(x), torch.tensor(dy),
                                           **kw), got)
