"""The port's CUDA kernels on the card: each held against its plain PyTorch
version, plus the wrappers' launch counts and refusals, the conv
kernels' determinism and the training steps' launches per step.

These tests need a CUDA card and skip without one.  They import no JAX
(the card's machine has none), so they run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4; kernel and plain version both sum in fp32
and differ only in summation order.  Flash attention in bf16: both sides
compute the same fp32 values from the same bf16 inputs and round once, so
they may differ by one bf16 ulp: rtol = 2^-7, atol = 1e-4 (the wgmma
form splits P into two bf16 terms to stay in that class).  Repeated
launches of a conv kernel on the engine or of flash attention on the
same inputs must agree bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cases import (ATTN_SWEEP, BACKWARD_GRID, EP_KW, FWD_GRID,
                          TCONV_GRID, attention_case, backward_case,
                          tconv_case)
from repro_torch.core.conv import ecoflow_conv, ecoflow_conv_transpose
from repro_torch.core.spec import ConvSpec, Epilogue, resolve_backend
from repro_torch.data.pipeline import ConvDataset
from repro_torch.kernels import ops
from repro_torch.kernels.attention import backward_plan as attn_bwd_plan
from repro_torch.kernels.attention import (AttentionPlan,
                                           flash_attention_backward_cuda,
                                           flash_attention_backward_plain,
                                           flash_attention_cuda,
                                           flash_attention_plain, plan)
from repro_torch.kernels.dconv_backward import (PATCH, BackwardPlan,
                                                conv_backward_cuda,
                                                conv_backward_plain, counted,
                                                patch_plan, phase_classes,
                                                plan as backward_plan,
                                                split_chunk,
                                                tconv_backward_plain)
from repro_torch.kernels.dconv_filtergrad import dconv_filter_grad_plain
from repro_torch.kernels.dconv_forward import dconv_forward_plain
from repro_torch.kernels.implicit_gemm import plan as ig_plan
from repro_torch.kernels.implicit_gemm import tconv_implicit_gemm_plain
from repro_torch.kernels.tconv_phase import tconv_fused_plain
from repro_torch.models import cnn, gan
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.lm import LM
from repro_torch.serve.decode_graph import DecodeGraph, buckets

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(gen, *shape, device):
    return torch.randn(shape, generator=gen).to(device)


@pytest.mark.parametrize("geom", TCONV_GRID)
@pytest.mark.parametrize("strategy", ["phase", "implicit_gemm"])
def test_tconv_kernels_match_plain(cuda, geom, strategy):
    spec, n_out, dy, w, bias = (
        torch.tensor(a).to(cuda) if isinstance(a, np.ndarray) else a
        for a in tconv_case(geom, 3))
    plain = tconv_implicit_gemm_plain if strategy == "implicit_gemm" \
        else tconv_fused_plain
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        b = bias if ep is not None and ep.bias else None
        got = ops.tconv_phase(dy, w, stride=spec.stride,
                              padding=spec.padding, n_out=n_out,
                              dilation=spec.dilation, bias=b, epilogue=ep,
                              strategy=strategy)
        want = plain(dy, w, spec, n_out=n_out, bias=b, epilogue=ep)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geom", FWD_GRID)
def test_dconv_forward_kernel_matches_plain(cuda, geom):
    s, d, k, p = geom
    spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    gen = torch.Generator().manual_seed(4)
    x = _rand(gen, 3, 17, 13, 5, device=cuda)
    w = _rand(gen, *spec.filter_shape, 5, 7, device=cuda)
    bias = _rand(gen, 7, device=cuda)
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        b = bias if ep is not None and ep.bias else None
        got = ops.dconv_forward(x, w, stride=s, padding=p, dilation=d,
                                bias=b, epilogue=ep)
        want = dconv_forward_plain(x, w, spec, bias=b, epilogue=ep)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


# The forwards' plan edges on the card, as TCONV_GRID geometries (stride,
# dilation, filter, padding, batch, dy size, Cin, Cout, n_out slack) and
# (batch, x side, Cin, Cout, K, S, P, D): residues no tap reaches (S = 3 >
# K = 2) whose outputs take the bias fill ep(0), a non-exact n_out tail,
# reductions the plan splits, ragged channels, and an ASPP branch (the
# 256 x 16 tile, D = 4).
TCONV_EDGES = [
    ("bias_fill_s3_k2", (3, 1, 2, 0, 2, (4, 4), 3, 40, 0)),
    ("nonexact_tail", (2, 1, 3, 0, 2, (4, 4), 3, 48, 1)),
    ("split", (2, 1, 4, 1, 2, (4, 4), 64, 128, 0)),
    ("ragged_channels", (2, 1, 3, 1, 2, (5, 5), 130, 37, 0)),
]
FWD_EDGES = [
    ("split", (2, (8, 8), 72, 24, 3, 1, 1, 1)),
    ("ragged_channels", (2, (9, 9), 130, 37, 3, 2, 1, 1)),
    ("aspp_rate4", (1, (64, 64), 3, 16, 3, 1, 4, 4)),
]


@pytest.mark.parametrize("name,geom", TCONV_EDGES,
                         ids=[c[0] for c in TCONV_EDGES])
def test_tconv_phase_kernel_at_plan_edges(cuda, name, geom):
    """Against the plain version under the four epilogues of EP_KW; a
    rerun is bit-identical."""
    spec, n_out, dy, w, bias = (
        torch.tensor(a).to(cuda) if isinstance(a, np.ndarray) else a
        for a in tconv_case(geom, 8))
    p = backward_plan("tconv_phase", spec, dy.shape[0], n_out,
                      tuple(dy.shape[1:3]), w.shape[2], w.shape[3],
                      n_out=n_out)
    if name == "split":
        assert p.splits > 1
    if name == "bias_fill_s3_k2":
        assert any(taps == 0 for _, _, taps in phase_classes(spec, n_out))
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        b = bias if ep is not None and ep.bias else None
        runs = [ops.tconv_phase(dy, w, stride=spec.stride,
                                padding=spec.padding, n_out=n_out,
                                dilation=spec.dilation, bias=b, epilogue=ep,
                                strategy="phase") for _ in range(2)]
        torch.testing.assert_close(
            runs[0], tconv_fused_plain(dy, w, spec, n_out=n_out, bias=b,
                                       epilogue=ep), atol=TOL, rtol=TOL)
        assert torch.equal(runs[0], runs[1])


# The implicit-GEMM kernel's plan edges, as TCONV_GRID geometries: Cout
# not a multiple of 4 (4-byte copies) with an n_out tail, Cout over one
# chunk (37, 130), Cin over one thread's register tile (130), many tiles
# per image (B = 1, 64 x 64), wide halos (S = 1 with D = 2; K = 11 with
# S = 4, whose chunk shrinks to fit two stages), and residues no tap
# reaches (S = 3, K = 2) over two chunks.
IG_EDGES = [
    ("cout7_tail", (2, 1, 4, 1, 2, (5, 5), 3, 7, 1)),
    ("ragged_channels", (2, 1, 3, 1, 2, (5, 5), 130, 37, 0)),
    ("cout130", (2, 1, 3, 1, 2, (5, 5), 5, 130, 0)),
    ("b1_64x64", (2, 1, 4, 1, 1, (32, 32), 3, 32, 0)),
    ("s1_d2", (1, 2, 3, 2, 2, (20, 20), 5, 12, 0)),
    ("k11_s4", (4, 1, 11, 0, 2, (6, 6), 5, 40, 0)),
    ("bias_fill_s3_k2", (3, 1, 2, 0, 2, (4, 4), 3, 40, 0)),
]


@pytest.mark.parametrize("name,geom", IG_EDGES, ids=[c[0] for c in IG_EDGES])
def test_implicit_gemm_kernel_at_plan_edges(cuda, name, geom):
    """Against the plain version under the four epilogues of EP_KW; a
    rerun is bit-identical."""
    spec, n_out, dy, w, bias = (
        torch.tensor(a).to(cuda) if isinstance(a, np.ndarray) else a
        for a in tconv_case(geom, 11))
    p = ig_plan(spec, dy.shape[0], n_out, tuple(dy.shape[1:3]), w.shape[2],
                w.shape[3])
    if name in ("ragged_channels", "cout130", "bias_fill_s3_k2"):
        assert p.stages == 2
    if name == "b1_64x64":
        assert p.tiles > 4
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        b = bias if ep is not None and ep.bias else None
        runs = [ops.tconv_phase(dy, w, stride=spec.stride,
                                padding=spec.padding, n_out=n_out,
                                dilation=spec.dilation, bias=b, epilogue=ep,
                                strategy="implicit_gemm") for _ in range(2)]
        torch.testing.assert_close(
            runs[0], tconv_implicit_gemm_plain(dy, w, spec, n_out=n_out,
                                               bias=b, epilogue=ep),
            atol=TOL, rtol=TOL)
        assert torch.equal(runs[0], runs[1])


def test_implicit_gemm_reads_operands_off_the_16_byte_grid(cuda):
    """dy and w contiguous but one float past a 16-byte boundary: the
    kernel takes its 4-byte copies and still matches the plain version."""
    spec, n_out, dy, w, bias = tconv_case((2, 1, 4, 1, 2, (16, 16), 3, 32,
                                           0), 12)

    def shifted(a):
        flat = torch.zeros(a.size + 1, device=cuda)
        flat[1:] = torch.tensor(a.ravel(), device=cuda)
        return flat[1:].view(a.shape)

    dy, w = shifted(dy), shifted(w)
    assert dy.is_contiguous() and dy.data_ptr() % 16 != 0
    got = ops.tconv_implicit_gemm(dy, w, stride=spec.stride,
                                  padding=spec.padding, n_out=n_out)
    torch.testing.assert_close(
        got, tconv_implicit_gemm_plain(dy, w, spec, n_out=n_out), atol=TOL,
        rtol=TOL)


def test_implicit_gemm_refuses_a_plan_out_of_range(cuda):
    """The C entry checks the plan it is given: a tile that is not a
    multiple of the stride is refused, and the launcher raises.  (The plan
    is passed to the launcher: the planner memoizes what `plan` returns,
    so a patched `plan` would outlive the test.)"""
    from repro_torch.kernels import implicit_gemm
    gen = torch.Generator().manual_seed(6)
    dy = _rand(gen, 2, 4, 4, 8, device=cuda)
    w = _rand(gen, 4, 4, 3, 8, device=cuda)
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    good = implicit_gemm.plan(spec, 2, (8, 8), (4, 4), 3, 8)
    with pytest.raises(RuntimeError, match="implicit_gemm kernel launch"):
        implicit_gemm.tconv_implicit_gemm_cuda(dy, w, spec, n_out=(8, 8),
                                               plan=good._replace(th=3))


@pytest.mark.parametrize("name,geom", FWD_EDGES, ids=[c[0] for c in FWD_EDGES])
def test_dconv_forward_kernel_at_plan_edges(cuda, name, geom):
    """Against the plain version under the four epilogues of EP_KW; a
    rerun is bit-identical."""
    B, hw, cin, cout, k, s, p_, d = geom
    spec = ConvSpec.make(stride=s, padding=p_, filter_shape=k, dilation=d)
    gen = torch.Generator().manual_seed(len(name))
    x = _rand(gen, B, *hw, cin, device=cuda)
    w = _rand(gen, k, k, cin, cout, device=cuda)
    bias = _rand(gen, cout, device=cuda)
    p = backward_plan("dconv_forward", spec, B, hw, spec.out_size(hw), cin,
                      cout)
    if name == "split":
        assert p.splits > 1
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        b = bias if ep is not None and ep.bias else None
        runs = [ops.dconv_forward(x, w, stride=s, padding=p_, dilation=d,
                                  bias=b, epilogue=ep) for _ in range(2)]
        torch.testing.assert_close(
            runs[0], dconv_forward_plain(x, w, spec, bias=b, epilogue=ep),
            atol=TOL, rtol=TOL)
        assert torch.equal(runs[0], runs[1])


def test_each_wrapper_counts_its_launches(cuda):
    gen = torch.Generator().manual_seed(5)
    dy = _rand(gen, 2, 4, 4, 8, device=cuda)
    ops.reset_launches()
    ops.tconv_phase(dy, _rand(gen, 4, 4, 16, 8, device=cuda), stride=2,
                    padding=1, n_out=(8, 8), strategy="phase")
    ops.tconv_phase(dy, _rand(gen, 4, 4, 3, 8, device=cuda), stride=2,
                    padding=1, n_out=(8, 8))    # the race: implicit GEMM
    ops.dconv_forward(_rand(gen, 1, 8, 8, 3, device=cuda),
                      _rand(gen, 3, 3, 3, 4, device=cuda), stride=1,
                      padding=2, dilation=2)
    assert ops.LAUNCHES == {"dconv_forward": 1, "tconv_phase": 1,
                            "tconv_implicit_gemm": 1, "conv_backward": 0,
                            "tconv_backward": 0, "dconv_filter_grad": 0,
                            "flash_attention": 0,
                            "flash_attention_backward": 0}
    assert ops.FLASH_BWD_FORMS == {"simt": 0, "wgmma": 0}
    ops.dconv_forward(_rand(gen, 1, 8, 8, 3, device="cpu"),
                      _rand(gen, 3, 3, 3, 4, device="cpu"), stride=1,
                      padding=2, dilation=2)              # plain: no launch
    assert ops.LAUNCHES["dconv_forward"] == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda)
    w = torch.zeros((3, 3, 3, 4), device=cuda)
    with pytest.raises(TypeError):
        ops.dconv_forward(x.double(), w.double(), stride=1, padding=1,
                          dilation=1)
    with pytest.raises(ValueError):
        ops.dconv_forward(x, w.cpu(), stride=1, padding=1, dilation=1)


def test_cuda_backend_training_slots_raise(cuda):
    """The name is kept from the serving slice, when these slots raised on
    the card: each backward slot now launches its kernel, and gradients
    flow through the autograd Functions on the cuda backend."""
    be = resolve_backend("cuda")
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    gen = torch.Generator().manual_seed(6)
    x = _rand(gen, 2, 8, 8, 3, device=cuda)
    dy = _rand(gen, 2, 4, 4, 5, device=cuda)
    w = _rand(gen, 4, 4, 3, 5, device=cuda)
    ops.reset_launches()
    torch.testing.assert_close(be.filter_grad(x, dy, spec),
                               dconv_filter_grad_plain(x, dy, spec),
                               atol=TOL, rtol=TOL)
    dx, dw = be.backward(x, dy, w, spec, (8, 8))
    want = conv_backward_plain(x, dy, w, spec, n_out=(8, 8))
    torch.testing.assert_close((dx, dw), want[:2], atol=TOL, rtol=TOL)
    wg = w.clone().requires_grad_()
    dyg = dy.clone().requires_grad_()
    z = ecoflow_conv_transpose(dyg, wg, 2, 1, backend="cuda",
                               epilogue=Epilogue(activation="relu"))
    z.sum().backward()
    y = ecoflow_conv(x, wg, 2, 1, "cuda",
                     epilogue=Epilogue(activation="leaky_relu", slope=0.2))
    y.sum().backward()
    assert dyg.grad is not None and wg.grad is not None
    assert ops.LAUNCHES["dconv_filter_grad"] == 1
    assert ops.LAUNCHES["conv_backward"] == 2
    assert ops.LAUNCHES["tconv_backward"] == 1


def _cuda_case(geom, seed, cuda):
    c = backward_case(geom, seed)
    return {k: torch.tensor(v).to(cuda) if isinstance(v, np.ndarray) else v
            for k, v in c.items()}


def _spec(c):
    s, p, k, d = c["spec"]
    return ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)


def _assert_same_outputs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_conv_backward_kernel_matches_plain(cuda, geom):
    c = _cuda_case(geom, 11, cuda)
    spec = _spec(c)
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        y = torch.tanh(c["y"]) if kw is not None and \
            kw["activation"] == "tanh" else c["y"]
        got = ops.conv_backward(c["x"], c["dy"], c["w"], stride=spec.stride,
                                padding=spec.padding, n_out=c["n"],
                                dilation=spec.dilation, y=y, epilogue=ep)
        want = conv_backward_plain(c["x"], c["dy"], c["w"], spec,
                                   n_out=c["n"], y=y, epilogue=ep)
        _assert_same_outputs(got, want if ep is not None else want[:2])


@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_tconv_backward_kernel_matches_plain(cuda, geom):
    c = _cuda_case(geom, 12, cuda)
    spec = _spec(c)
    for kw in EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        z = torch.tanh(c["z"]) if kw is not None and \
            kw["activation"] == "tanh" else c["z"]
        got = ops.tconv_backward(c["g"], c["dy"], c["w"],
                                 stride=spec.stride, padding=spec.padding,
                                 dilation=spec.dilation, z=z, epilogue=ep)
        want = tconv_backward_plain(c["g"], c["dy"], c["w"], spec, z=z,
                                    epilogue=ep)
        _assert_same_outputs(got, want if ep is not None else want[:2])


@pytest.mark.parametrize("geom", BACKWARD_GRID, ids=lambda g: g[0])
def test_filter_grad_kernel_matches_plain(cuda, geom):
    c = _cuda_case(geom, 13, cuda)
    spec = _spec(c)
    got = ops.dconv_filter_grad(c["x"], c["dy"], stride=spec.stride,
                                padding=spec.padding, k=spec.filter_shape,
                                dilation=spec.dilation)
    torch.testing.assert_close(got, dconv_filter_grad_plain(c["x"], c["dy"],
                                                            spec),
                               atol=TOL, rtol=TOL)


def test_backward_kernels_are_bit_identical_over_runs(cuda):
    """dW and db sum in a fixed order: no atomics on them, the same bits,
    with the positions split over 32 CTAs and their partials added in
    split order."""
    gen = torch.Generator().manual_seed(14)
    ep = Epilogue(activation="leaky_relu", slope=0.2, bias=True, scale=0.5)
    x = _rand(gen, 16, 32, 32, 3, device=cuda)
    w = _rand(gen, 4, 4, 3, 32, device=cuda)
    dy = _rand(gen, 16, 16, 16, 32, device=cuda)
    y = _rand(gen, 16, 16, 16, 32, device=cuda)
    geo = dict(stride=2, padding=1)
    spec = ConvSpec.make(filter_shape=4, **geo)
    for op in ("conv_backward", "tconv_backward", "filter_grad"):
        assert backward_plan(op, spec, 16, (32, 32), (16, 16), 3, 32,
                             n_out=(32, 32), bias=True).dw_splits == 32
    runs = [ops.conv_backward(x, dy, w, n_out=(32, 32), y=y, epilogue=ep,
                              **geo) for _ in range(2)]
    runs += [ops.tconv_backward(x, dy, w, z=torch.tanh(x),
                                epilogue=Epilogue(activation="tanh",
                                                  bias=True), **geo)
             for _ in range(2)]
    runs += [(ops.dconv_filter_grad(x, dy, k=4, **geo),) for _ in range(2)]
    for a, b in zip(runs[::2], runs[1::2]):
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb)


# (name, kernel side (B, H, W), Cin, Cout, K, activation): the nine
# main-path layers at batch 64 (S = 2, P = 1) -- discriminator and CNN
# convs for conv_backward and dconv_filter_grad, generator layers for
# tconv_backward -- and the plan's edges: a position count the split
# count does not divide, Cin = 3 at B = 16, Cin 130 / Cout 37.
BACKWARD_LAYERS = [
    ("disc_c1", (64, 32, 32), 3, 32, 4, "leaky_relu"),
    ("disc_c2", (64, 16, 16), 32, 64, 4, "leaky_relu"),
    ("disc_c3", (64, 8, 8), 64, 128, 4, "leaky_relu"),
    ("cnn_l1", (64, 32, 32), 3, 32, 3, "relu"),
    ("cnn_l2", (64, 16, 16), 32, 64, 3, "relu"),
    ("cnn_l3", (64, 8, 8), 64, 128, 3, "relu"),
    ("gan_t1", (64, 8, 8), 64, 128, 4, "relu"),
    ("gan_t2", (64, 16, 16), 32, 64, 4, "relu"),
    ("gan_t3", (64, 32, 32), 3, 32, 4, "tanh"),
    ("positions_1183", (7, 26, 26), 8, 16, 3, "relu"),
    ("cin3_b16", (16, 32, 32), 3, 32, 4, "leaky_relu"),
    ("ragged_channels", (2, 9, 9), 130, 37, 3, "leaky_relu"),
]


@pytest.mark.parametrize("layer", BACKWARD_LAYERS, ids=lambda c: c[0])
def test_backward_kernels_at_the_path_layers_and_plan_edges(cuda, layer):
    """conv_backward, tconv_backward and dconv_filter_grad against their
    plain versions under the layer's epilogue and the four of EP_KW.  The
    cotangent is drawn at scale 1/sqrt(B*Oh*Ow), as in training, so each
    dW sum is of order 1.  Reruns are bit-identical."""
    name, (B, H, W), cin, cout, k, act = layer
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=k)
    oh, ow = spec.out_size((H, W))
    gen = torch.Generator().manual_seed(len(name))
    big = _rand(gen, B, H, W, cin, device=cuda)
    w = _rand(gen, k, k, cin, cout, device=cuda)
    small = _rand(gen, B, oh, ow, cout, device=cuda) / (B * oh * ow) ** 0.5
    geo = dict(stride=spec.stride, padding=spec.padding)
    for kw in [dict(activation=act, slope=0.2)] + EP_KW:
        ep = None if kw is None else Epilogue(**kw)
        tanh = kw is not None and kw["activation"] == "tanh"
        y = _rand(gen, B, oh, ow, cout, device=cuda)
        z = _rand(gen, B, H, W, cin, device=cuda)
        y, z = (torch.tanh(y), torch.tanh(z)) if tanh else (y, z)
        runs = [ops.conv_backward(big, small, w, n_out=(H, W), y=y,
                                  epilogue=ep, **geo) for _ in range(2)]
        want = conv_backward_plain(big, small, w, spec, n_out=(H, W), y=y,
                                   epilogue=ep)
        _assert_same_outputs(runs[0], want if ep is not None else want[:2])
        runs += [ops.tconv_backward(big, small, w, z=z, epilogue=ep, **geo)
                 for _ in range(2)]
        want = tconv_backward_plain(big, small, w, spec, z=z, epilogue=ep)
        _assert_same_outputs(runs[2], want if ep is not None else want[:2])
        for a, b in zip(runs[::2], runs[1::2]):
            assert all(torch.equal(ta, tb) for ta, tb in zip(a, b)
                       if ta is not None)
    dw = ops.dconv_filter_grad(big, small, k=k, **geo)
    torch.testing.assert_close(dw, dconv_filter_grad_plain(big, small, spec),
                               atol=TOL, rtol=TOL)
    assert torch.equal(dw, ops.dconv_filter_grad(big, small, k=k, **geo))


def _step_launches():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STEP_LAUNCHES


@pytest.mark.parametrize("step", ["gan_sgd_step", "gen_sgd_step",
                                  "sgd_step"])
def test_training_step_launches_per_step(cuda, step):
    """At the models' published widths (batch 8) each step launches each
    kernel as often as chip_smoke.py's table (held to `repro`'s
    pallas_call counts on the CPU) says, and no other kernel."""
    gen = torch.Generator().manual_seed(15)
    b = ConvDataset(kind="gan", batch=8, z_dim=64, seed=0).batch_at(0)
    z = torch.tensor(b["z"]).to(cuda)
    real = torch.tensor(b["real"]).to(cuda)
    ops.reset_launches()
    if step == "sgd_step":
        p = cnn.simple_cnn_init(gen, device=cuda)
        c = ConvDataset(kind="cnn", batch=8, image=32).batch_at(0)
        ops.reset_launches()
        cnn.sgd_step(p, torch.tensor(c["x"]).to(cuda),
                     torch.tensor(c["labels"]).to(cuda), backend="cuda")
    else:
        st = gan.gan_init(gen, device=cuda)
        ops.reset_launches()
        if step == "gen_sgd_step":
            gan.gen_sgd_step(st["g"], st["d"], z, backend="cuda")
        else:
            gan.gan_sgd_step(st, z, real, backend="cuda")
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == \
        _step_launches()[step]


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda)
    dy = torch.zeros((1, 4, 4, 5), device=cuda)
    w = torch.zeros((4, 4, 3, 5), device=cuda)
    geo = dict(stride=2, padding=1)
    with pytest.raises(TypeError):
        ops.conv_backward(x.double(), dy.double(), w.double(), n_out=(8, 8),
                          **geo)
    with pytest.raises(TypeError):
        ops.tconv_backward(x.half(), dy.half(), w.half(), **geo)
    with pytest.raises(ValueError, match="one device"):
        ops.conv_backward(x, dy.cpu(), w, n_out=(8, 8), **geo)
    with pytest.raises(ValueError, match="one device"):
        ops.tconv_backward(x, dy, w.cpu(), **geo)
    with pytest.raises(ValueError, match="one device"):
        ops.dconv_filter_grad(x.cpu(), dy, k=4, **geo)
    with pytest.raises(ValueError, match="one device"):
        ops.conv_backward(x, dy, w, n_out=(8, 8), y=dy.cpu(),
                          epilogue=Epilogue(activation="relu"), **geo)


def test_engine_on_the_card_has_no_plain_rung(cuda):
    """The default ladder on the card is the kernels' single rung; a
    ladder with plain rungs is taken when the caller names it."""
    from repro_torch.serve.conv_engine import DEFAULT_LADDER, ConvServeEngine
    assert ConvServeEngine(device=cuda).ladder == ("cuda",)
    assert ConvServeEngine(device=cuda, ladder=DEFAULT_LADDER).ladder == \
        DEFAULT_LADDER


def _card_engine(cuda, schedule=()):
    from repro_torch.serve.conv_engine import DEFAULT_LADDER, ConvServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultSchedule
    gp = gan.generator_init(torch.Generator().manual_seed(16), z_dim=8,
                            base=8, device=cuda)
    return ConvServeEngine(gan_params=gp, slot_batch=2, device=cuda,
                           ladder=DEFAULT_LADDER,
                           injector=FaultInjector(FaultSchedule(schedule)))


def _latents(n):
    from repro_torch.serve.conv_engine import ConvRequest
    rng = np.random.default_rng(17)
    return [ConvRequest(None, "gan_gen",
                        rng.standard_normal(8).astype(np.float32))
            for _ in range(n)]


def test_engine_on_the_card_degrades_on_an_injected_fault(cuda,
                                                          monkeypatch):
    """`cuda` always fails by injection: `torch_zero_free` serves on the
    card, equal to its own call on the CPU within TOL (cuDNN in fp32, no
    TF32), and no hand-written kernel is launched."""
    from repro_torch.serve.faults import FaultSchedule
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    eng = _card_engine(cuda, FaultSchedule.seeded(
        0, sites=["gan_gen:cuda"], rate=1.0, horizon=64,
        kinds=("kernel_exception",)).events)
    reqs = _latents(3)
    ops.reset_launches()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    assert len(res) == 3 and not any(ops.LAUNCHES.values())
    h = eng.health()
    assert h["kernel_faults"] == 2 and h["fallbacks"] == 2
    cpu = {k: v.cpu() for k, v in eng.gan_params.items()}
    with torch.no_grad():
        want = gan.generator_apply(
            cpu, torch.from_numpy(np.stack([r.payload for r in reqs])),
            backend="torch_zero_free").numpy()
    for r, w in zip(reqs, want):
        np.testing.assert_allclose(res[r.uid], w, rtol=TOL, atol=TOL)


def test_engine_on_the_card_propagates_an_error_it_did_not_inject(
        cuda, monkeypatch):
    def failed(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(ops, "tconv_phase", failed)
    eng = _card_engine(cuda)
    with pytest.raises(RuntimeError, match="launch failure"):
        eng.serve(_latents(1))
    assert eng.stats["fallbacks"] == 0 and eng.stats["kernel_faults"] == 1


def test_engine_on_the_card_raises_a_nan_it_did_not_inject(cuda,
                                                           monkeypatch):
    """A kernel that writes NaN with nothing injected (a race, shared
    memory left unwritten) surfaces as an error: no plain rung serves
    the cohort in its place."""
    real = ops.tconv_phase
    monkeypatch.setattr(ops, "tconv_phase",
                        lambda *a, **k: real(*a, **k).fill_(float("nan")))
    eng = _card_engine(cuda)
    with pytest.raises(RuntimeError, match="non-finite output of the "
                                           "'cuda' rung"):
        eng.serve(_latents(1))
    assert eng.stats["fallbacks"] == 0 and eng.stats["nan_events"] == 1


def test_fallback_backend_on_cuda_operands(cuda, monkeypatch):
    """Over `inject_backend("cuda", ...)` an injected fault degrades to
    `torch_zero_free` on the card, launching nothing; a kernel wrapper's
    own refusal (fp64 operands) propagates from the `cuda` rung, where on
    the CPU it would degrade."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from repro_torch.core.spec import fallback_backend
    from repro_torch.serve.faults import (FaultInjector, FaultSchedule,
                                          inject_backend)
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    gen = torch.Generator().manual_seed(18)
    x = _rand(gen, 2, 8, 8, 3, device=cuda)
    w = _rand(gen, 4, 4, 3, 5, device=cuda)
    inj = FaultInjector(FaultSchedule.seeded(
        0, sites=["cuda.forward"], rate=1.0, horizon=8,
        kinds=("kernel_exception",)))
    seen = []
    ladder = fallback_backend(
        (inject_backend("cuda", inj), "torch_zero_free"),
        on_fallback=lambda n, op, e: seen.append((n, op)))
    ops.reset_launches()
    y = ladder.forward(x, w, spec)
    assert not any(ops.LAUNCHES.values())
    assert seen == [("cuda@inject", "forward")] and y.is_cuda
    torch.testing.assert_close(
        y, resolve_backend("torch_zero_free").forward(x, w, spec),
        rtol=TOL, atol=TOL)
    ladder = fallback_backend(("cuda", "torch_zero_free"),
                              on_fallback=lambda n, op, e: seen.append(n))
    with pytest.raises(TypeError):
        ladder.forward(x.double(), w.double(), spec)
    assert len(seen) == 1


# (atol, rtol) of flash attention against its plain version.
ATTN_TOL = {torch.float32: (TOL, TOL), torch.bfloat16: (1e-4, 2.0 ** -7)}


def _attention_operands(case, dtype, device, seed):
    B, Sq, Sk, Hq, Hk, D = case
    return tuple(torch.tensor(a).to(device=device, dtype=dtype)
                 for a in attention_case(B, Sq, Sk, Hq, Hk, D, seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,bq,bk", ATTN_SWEEP + [
    (2, 300, 300, 8, 1, 256, True, 0, 0),     # MQA, head_dim 256
    (1, 40, 40, 2, 1, 16, True, 0, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Sk, Hq, Hk,
                                              D, causal, bq, bk):
    q, k, v = _attention_operands((B, Sq, Sk, Hq, Hk, D), dtype, cuda, 12)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_reads_a_strided_cache_view(cuda, dtype):
    """Decode: one query per sequence over the live prefix of a
    (B, Smax, Hk, D) cache, a view whose batch stride is Smax * Hk * D."""
    B, Smax, Hq, Hk, D, length = 3, 96, 8, 2, 128, 70
    q, ck, cv = _attention_operands((B, 1, Smax, Hq, Hk, D), dtype, cuda, 13)
    k, v = ck[:, :length + 1], cv[:, :length + 1]
    assert not k.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, q_offset=length)
    want = flash_attention_plain(q, k.contiguous(), v.contiguous(),
                                 causal=True, q_offset=length)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_flash_attention_refuses_an_operand_it_cannot_read_in_place(cuda):
    """The wrapper raises instead of copying an operand the kernel cannot
    read in place: no silent copy of a KV cache."""
    q = torch.zeros((1, 4, 4, 32), device=cuda)
    kv = torch.zeros((1, 4, 2, 32), device=cuda)
    shifted = torch.zeros(kv.numel() + 1, device=cuda)[1:].view(kv.shape)
    d_strided = torch.zeros((1, 4, 32, 2), device=cuda).transpose(2, 3)
    ops.reset_launches()
    for k in (shifted, d_strided):
        with pytest.raises(ValueError, match="in place"):
            ops.flash_attention(q, k, kv)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dryrun_fake_forms_launch_nothing_and_real_tensors_launch(
        cuda, dtype, monkeypatch):
    """The dry-run's fake forms on the card: fake `cuda` operands run the
    kernels' shape-only forms through autograd -- nothing built or
    launched, each call counted among the fake forms' calls in the form
    the plan picks and none in LAUNCHES -- and a real operand launches
    the kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import attention, build
    B, Sq, Sk, Hq, Hk, D = 1, 128, 128, 8, 2, 128
    q, k, v = _attention_operands((B, Sq, Sk, Hq, Hk, D), dtype, cuda, 14)
    want = ops.flash_attention(q, k, v)         # builds / loads the kernel
    ops.reset_launches()

    def refuse(*a, **kw):
        raise AssertionError("a fake form reached the kernel")
    with monkeypatch.context() as m:
        m.setattr(build, "kernel_function", refuse)
        m.setattr(build, "build", refuse)
        with FakeTensorMode() as mode:
            fq, fk, fv = (mode.from_tensor(t).requires_grad_()
                          for t in (q, k, v))
            out = ops.flash_attention(fq, fk, fv)
            grads = torch.autograd.grad(out.float().sum(), (fq, fk, fv))
    assert out.device.type == "cuda" and out.shape == q.shape
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert not any(ops.LAUNCHES.values())
    assert attention.FAKE_CALLS == {"flash_attention": 1,
                                    "flash_attention_backward": 1}
    form = plan(dtype, B, Sq, Sk, Hq, Hk, D).form
    assert attention.FAKE_FORMS["forward"][form] == 1
    assert attention.FAKE_FORMS["backward"][
        attn_bwd_plan(dtype, B, Sq, Sk, Hq, Hk, D)] == 1
    assert attention.FAKE_FLOPS["flash_attention"] == \
        4 * D * B * Hq * attention.visible_pairs(Sq, Sk, True, 0)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert attention.FAKE_CALLS["flash_attention"] == 0
    assert torch.equal(got, want)


def test_flash_attention_refuses_mixed_devices(cuda):
    q = torch.zeros((1, 4, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="one device"):
        ops.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())


def test_lm_launches_one_attention_kernel_per_layer(cuda):
    cfg = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=64,
                      d_ff=128, vocab=97, n_heads=4, n_kv_heads=2,
                      head_dim=16, qk_norm=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(16), device=cuda)
    toks = torch.randint(0, 97, (2, 9), generator=torch.Generator()
                         .manual_seed(16)).to(cuda)
    ops.reset_launches()
    logits, cache = lm.prefill(params, toks, 16)
    assert ops.LAUNCHES["flash_attention"] == 3
    logits, cache = lm.decode_step(params, cache, toks[:, :1])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 6
    assert bool(torch.isfinite(logits).all())
    assert {k for k, n in ops.LAUNCHES.items() if n} == {"flash_attention"}


# (Sq, Sk, causal) at the forms' edges: one query (the split form), rows
# about the 64-row tile and keys about the 64-key tile, a long cache.
ATTN_EDGES = [(1, 1, True), (1, 63, True), (1, 64, True), (1, 65, True),
              (1, 1024, True), (63, 63, True), (64, 64, True),
              (65, 65, False), (65, 300, True), (300, 300, True),
              (64, 1024, False), (1024, 1024, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal", ATTN_EDGES)
def test_flash_attention_forms_at_tile_edges(cuda, dtype, D, Sq, Sk, causal):
    """Each form against the plain version at the tile edges, every
    head_dim; GQA g = 2.  Reruns are bit-identical."""
    q, k, v = _attention_operands((2, Sq, Sk, 4, 2, D), dtype, cuda, Sk)
    form = plan(dtype, 2, Sq, Sk, 4, 2, D).form
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.FLASH_FORMS == {f: int(f == form) for f in ops.FLASH_FORMS}
    want = flash_attention_plain(q, k, v, causal=causal)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Sq,Sk,D", [(1, 300, 256), (1, 1024, 128),
                                     (65, 65, 64), (300, 300, 256),
                                     (64, 1024, 128)])
def test_flash_attention_forms_mqa_g8(cuda, dtype, Sq, Sk, D):
    """MQA with eight query heads per kv head: 8 rows per kv head at
    Sq = 1 (the split form's most), 512 per 64 queries (wgmma)."""
    q, k, v = _attention_operands((2, Sq, Sk, 8, 1, D), dtype, cuda, 17)
    got = ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Sq", [1, 2, 65, 200])
def test_flash_attention_forms_with_a_q_offset(cuda, dtype, Sq):
    """Queries at positions 100.. over 600 keys: the keys past a row's
    position are masked in every form, and the split form's later
    splits see no key at all."""
    q, k, v = _attention_operands((2, Sq, 600, 4, 2, 128), dtype, cuda, 19)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=100)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=100)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                q_offset=100))


# (B, Sq, Sk, Hq, Hk, D, causal, q_offset) of the backward: every head_dim,
# g = 1 and 2, MQA, causal or not, Sq = Sk ragged about the 64-row and
# 64-key blocks, and Sq < Sk with a q_offset (None: Sk - Sq).
ATTN_BWD_CASES = [
    (1, 63, 63, 2, 2, 16, True, None), (2, 65, 65, 4, 2, 32, True, None),
    (1, 64, 64, 4, 1, 64, True, None), (1, 130, 130, 4, 2, 128, True, None),
    (1, 70, 70, 2, 1, 256, True, None), (1, 33, 70, 4, 2, 16, False, None),
    (1, 100, 300, 4, 2, 128, True, 37), (2, 40, 90, 2, 2, 64, True, None),
    (1, 65, 65, 4, 2, 128, False, None), (1, 1, 40, 4, 4, 32, True, None),
    (1, 130, 130, 4, 2, 80, True, None), (2, 65, 100, 4, 4, 80, True, 20)]


def _forward_with_lse(q, k, v, causal, off):
    """The forward kernel's (out, lse), in the form the wrapper plans."""
    form = plan(q.dtype, q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                k.shape[2], q.shape[3])
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                                form=form, return_lse=True)


def _attention_grad_operands(case, dtype, device, seed):
    """q, k, v, the forward's output and lse through the kernel, and a
    seeded cotangent."""
    B, Sq, Sk, Hq, Hk, D, causal, off = case
    q, k, v = _attention_operands((B, Sq, Sk, Hq, Hk, D), dtype, device, seed)
    off = Sk - Sq if off is None else off
    out, lse = _forward_with_lse(q, k, v, causal, off)
    do = torch.tensor(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(device=device, dtype=dtype)
    return q, k, v, out, lse, do, causal, off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_flash_attention_lse_matches_plain(cuda, dtype, case):
    """Every form writes the lse that normalised its output; asking for it
    leaves the output bit for bit as without."""
    q, k, v, out, lse, _, causal, off = _attention_grad_operands(
        case, dtype, cuda, 31)
    want_out, want = flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=off, return_lse=True)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    torch.testing.assert_close(lse, want, atol=TOL, rtol=TOL)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal,
                                                q_offset=off))


@pytest.mark.parametrize("Sq", [1, 8, 200])
def test_flash_attention_lse_from_the_split_and_wgmma_forms(cuda, Sq):
    q, k, v = _attention_operands((2, Sq, 600, 4, 2, 128), torch.bfloat16,
                                  cuda, 32)
    out, lse = _forward_with_lse(q, k, v, True, 100)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=100,
                                 return_lse=True)[1]
    torch.testing.assert_close(lse, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, case):
    """On the form `backward_plan` picks: bf16 at head_dim 64 / 80 / 128
    on wgmma, the rest on simt."""
    _check_backward_form(cuda, dtype, case, None, 33)


def _check_backward_form(cuda, dtype, case, form, seed):
    """The backward against its plain version at ATTN_TOL, and a rerun bit
    for bit: through the wrapper on the plan's form, counted once in
    FLASH_BWD_FORMS (`form` None), or launched in `form`."""
    q, k, v, out, lse, do, causal, off = _attention_grad_operands(
        case, dtype, cuda, seed)

    def run():
        if form is None:
            return ops.flash_attention_backward(q, k, v, out, do, lse,
                                                causal=causal, q_offset=off)
        return flash_attention_backward_cuda(q, k, v, out, do, lse,
                                             causal=causal, q_offset=off,
                                             form=form)

    ops.reset_launches()
    got = run()
    if form is None:
        want_form = attn_bwd_plan(dtype, *case[:6])
        assert ops.LAUNCHES["flash_attention_backward"] == 1
        assert ops.FLASH_BWD_FORMS == {f: int(f == want_form)
                                       for f in ops.FLASH_BWD_FORMS}
    want = flash_attention_backward_plain(q, k, v, out, do, lse,
                                          causal=causal, q_offset=off)
    atol, rtol = ATTN_TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_flash_attention_backward_wgmma_form_at_every_geometry(cuda, case,
                                                                D):
    """Every ATTN_BWD_CASES geometry in bf16 at head_dim 64, 80 and 128
    runs on the tensor-core form: ragged rows and keys (63, 65, 70, 130,
    one query), MQA, q_offset, causal or not."""
    case = case[:5] + (D,) + case[6:]
    assert attn_bwd_plan(torch.bfloat16, *case[:6]) == "wgmma"
    _check_backward_form(cuda, torch.bfloat16, case, None, 35)


def test_flash_attention_backward_simt_form_stays_tested_in_bf16(cuda):
    """The SIMT form forced at a bf16 head_dim 128 case the plan sends to
    wgmma."""
    case = (1, 130, 130, 4, 2, 128, True, None)
    assert attn_bwd_plan(torch.bfloat16, *case[:6]) == "wgmma"
    _check_backward_form(cuda, torch.bfloat16, case, "simt", 36)


def test_flash_attention_backward_refuses_a_form_the_shapes_do_not_take(
        cuda):
    """No fallback: the wgmma form refuses fp32 and head_dim 32 (the
    kernel's entry returns cudaErrorInvalidValue and the launcher
    raises), and an unknown form raises before any launch."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v, out, lse, do, causal, off = _attention_grad_operands(
            (1, 70, 70, 4, 2, D, True, None), dtype, cuda, 37)
        with pytest.raises(RuntimeError, match="invalid argument"):
            flash_attention_backward_cuda(q, k, v, out, do, lse,
                                          causal=causal, q_offset=off,
                                          form="wgmma")
        with pytest.raises(ValueError):
            flash_attention_backward_cuda(q, k, v, out, do, lse,
                                          causal=causal, q_offset=off,
                                          form="tile")


# (B, Sq, Sk, Hq, Hk, D, causal, q_offset) at head_dim 80 in bf16: rows
# and keys ragged about the 64-row and 64-key tiles (Sq 70, Sk 130), GQA
# g = 2, a q_offset of Sk - Sq and one below it (keys no query sees), and
# full attention.
D80_WGMMA_CASES = [(1, 70, 130, 4, 2, 80, True, 60),
                   (2, 70, 130, 4, 2, 80, True, 20),
                   (1, 70, 130, 4, 2, 80, False, 0),
                   (1, 130, 130, 2, 2, 80, True, None)]


@pytest.mark.parametrize("case", D80_WGMMA_CASES)
def test_wgmma_forms_at_head_dim_80_match_plain(cuda, case):
    """The tensor-core forms at head_dim 80 (two 64-column panels, the
    second 16 columns wide): the forward's output and lse and the
    backward's dq, dk, dv against their plain versions at one bf16 ulp,
    each rerun bit for bit; the plans send bf16 at 80 to them."""
    q, k, v, out, lse, do, causal, off = _attention_grad_operands(
        case, torch.bfloat16, cuda, 42)
    form = plan(torch.bfloat16, *case[:6])
    assert form.form == "wgmma"
    assert attn_bwd_plan(torch.bfloat16, *case[:6]) == "wgmma"
    want_out, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                               q_offset=off, return_lse=True)
    atol, rtol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    again = flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                                 form=form, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    _check_backward_form(cuda, torch.bfloat16, case, None, 42)


def test_tile_and_simt_forms_forced_at_bf16_head_dim_80(cuda):
    """The SIMT forms stay held at bf16 / 80, where the plans now send the
    call to wgmma: forced, each matches its plain version and reruns bit
    for bit.  No fallback: the wgmma forms refuse fp32 and head_dim 32
    (cudaErrorInvalidValue, and the launcher raises)."""
    case = (1, 70, 130, 4, 2, 80, True, 60)
    q, k, v, out, lse, do, causal, off = _attention_grad_operands(
        case, torch.bfloat16, cuda, 43)
    tile = AttentionPlan("tile", 1)
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                               form=tile)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    atol, rtol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, flash_attention_cuda(
        q, k, v, causal=causal, q_offset=off, form=tile))
    _check_backward_form(cuda, torch.bfloat16, case, "simt", 43)
    wgmma = AttentionPlan("wgmma", 1)
    for dtype, D in ((torch.float32, 80), (torch.bfloat16, 32)):
        q, k, v = _attention_operands((1, 70, 70, 4, 2, D), dtype, cuda, 44)
        with pytest.raises(RuntimeError, match="invalid argument"):
            flash_attention_cuda(q, k, v, causal=True, q_offset=0,
                                 form=wgmma)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_head_dim_80_at_zamba2s_shape(cuda, dtype):
    """zamba2-2.7b's shared block at the engine's batch 4 (MHA 32 heads,
    head_dim 80): a prefill of 1000 (bf16 on wgmma, fp32 on tile), a
    decode over a strided cache on split, the backward at 1024 (bf16 on
    wgmma, fp32 on simt) -- each against its plain version, each rerun
    bit for bit."""
    q, k, v = _attention_operands((4, 1000, 1000, 32, 32, 80), dtype, cuda,
                                  39)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    qd, ck, cv = _attention_operands((4, 1, 2048, 32, 32, 80), dtype, cuda,
                                     40)
    dec = ops.flash_attention(qd, ck[:, :1025], cv[:, :1025], causal=True,
                              q_offset=1024)
    bf16 = dtype == torch.bfloat16
    assert ops.FLASH_FORMS == {"tile": int(not bf16), "wgmma": int(bf16),
                               "split": 1}
    atol, rtol = ATTN_TOL[dtype]
    for a, b in ((got, flash_attention_plain(q, k, v, causal=True)),
                 (dec, flash_attention_plain(qd, ck[:, :1025], cv[:, :1025],
                                             causal=True, q_offset=1024))):
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True))
    assert torch.equal(dec, ops.flash_attention(
        qd, ck[:, :1025], cv[:, :1025], causal=True, q_offset=1024))
    _check_backward_form(cuda, dtype, (4, 1024, 1024, 32, 32, 80, True, None),
                         None, 41)


def test_flash_attention_grad_launches_both_kernels(cuda):
    """An operand that requires grad takes the autograd Function: one
    forward launch writing the lse, one backward call, and gradients for
    q, k and v; a strided cotangent is made contiguous."""
    q, k, v = _attention_operands((2, 70, 70, 4, 2, 64), torch.bfloat16,
                                  cuda, 34)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    do = torch.randn((2, 4, 70, 64), device=cuda).to(torch.bfloat16)
    (out * do.transpose(1, 2)).float().sum().backward()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_backward"] == 1
    assert ops.FLASH_FORMS == {"tile": 0, "wgmma": 1, "split": 0}
    assert ops.FLASH_BWD_FORMS == {"simt": 0, "wgmma": 1}
    want = flash_attention_backward_plain(
        *(t.detach() for t in (q, k, v, out)), do.transpose(1, 2),
        flash_attention_plain(q.detach(), k.detach(), v.detach(),
                              return_lse=True)[1], causal=True, q_offset=0)
    atol, rtol = ATTN_TOL[torch.bfloat16]
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad.float(), w.float(), atol=atol,
                                   rtol=rtol)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_engine_prefills_on_wgmma_and_decodes_on_split(cuda):
    """A bf16 LM (head_dim 64) through ServeEngine: every prefill
    attention runs on the tensor-core form, one launch per layer per
    prefill; the decode steps replay one CUDA graph per cache-length
    bucket, whose wrappers run (and count) only at each bucket's eager
    first step and its capture: two split-form launches per layer per
    capture, each reading the device length; every other decode step is
    a replay, counted by the graph from its capture's launches."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                      d_ff=256, vocab=97, n_heads=4, n_kv_heads=2,
                      head_dim=64, qk_norm=True)
    params = LM(cfg).init(torch.Generator().manual_seed(18), device=cuda)
    rng = np.random.default_rng(18)
    reqs = [Request(uid=i, prompt=rng.integers(1, 97, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((40, 5), (90, 3), (33, 6)))]
    eng = ServeEngine(cfg, params, batch=2, max_len=128, device=cuda)
    ops.reset_launches()
    eng.generate(reqs)
    torch.cuda.synchronize()
    prefills, decodes = eng.stats["prefills"], eng.stats["decode_steps"]
    captures = eng.graph.captures
    assert prefills >= 2 and decodes > captures >= 1
    assert captures == len(eng.graph.graphs) <= len(buckets(128))
    assert ops.FLASH_FORMS == {"tile": 0, "wgmma": 2 * prefills,
                               "split": 2 * 2 * captures}
    assert ops.FLASH_DEVICE_LEN == {"split": 2 * 2 * captures}
    assert ops.LAUNCHES["flash_attention"] == 2 * (prefills + 2 * captures)
    assert eng.graph.replay_launches == {
        "flash_attention": 2 * (decodes - captures)}


def _int8_cfg():
    """A 2-layer int8-KV LM at qwen3-0.6b's head layout (GQA g 2, head_dim
    128, qk_norm) in fp32."""
    return ModelConfig(name="tiny-int8", family="dense", n_layers=2,
                       d_model=256, d_ff=512, vocab=211, n_heads=4,
                       n_kv_heads=2, head_dim=128, qk_norm=True,
                       kv_quant=True, dtype="float32")


@pytest.mark.parametrize("S", [1, 3])
def test_int8_kv_decode_attention_matches_plain(cuda, S):
    """`attention_decode_quant` on CUDA tensors (the live prefix
    dequantized to fp32, one split-form launch) against its plain
    version on CPU copies of the same inputs: within 1e-4, codes and
    scales written in place at cache_len."""
    cfg = _int8_cfg()
    gen = torch.Generator().manual_seed(30)
    params = L.attention_init(gen, cfg)
    B, Smax, clen = 3, 300, 257
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    kq, ks = L.kv_quantize(torch.randn((B, Smax, cfg.n_kv_heads,
                                        cfg.head_dim), generator=gen))
    vq, vs = L.kv_quantize(torch.randn((B, Smax, cfg.n_kv_heads,
                                        cfg.head_dim), generator=gen))
    cpu = [t.clone() for t in (kq, vq, ks, vs)]
    dev = [t.to(cuda) for t in (kq, vq, ks, vs)]
    want = L.attention_decode_quant(params, x, cfg, *cpu, clen)
    ops.reset_launches()
    got = L.attention_decode_quant(tree_map(lambda t: t.to(cuda), params),
                                   x.to(cuda), cfg, *dev, clen)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.FLASH_FORMS["split"] == 1
    assert all(a is b for a, b in zip(got[1:], dev))
    torch.testing.assert_close(got[0].cpu(), want[0], atol=TOL, rtol=TOL)
    for g, w in zip(got[1:3], want[1:3]):
        assert (g.cpu().int() - w.int()).abs().max() <= 1
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g.cpu(), w, atol=0.0, rtol=TOL)


def test_int8_kv_lm_matches_the_cpu(cuda):
    """Prefill and 4 decode steps of an int8-KV LM on the card against the
    same calls on the CPU (plain versions): logits within 1e-3 (as smoke
    phase 10 (a)), codes at most 1 apart, scales within 1e-4; one launch
    per layer per call, the prefill on `tile` and each decode on
    `split`."""
    cfg = _int8_cfg()
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(31), device="cpu")
    dparams = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(31)
    toks = torch.from_numpy(rng.integers(1, 211, (2, 70)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(1, 211, (4, 2, 1)).astype(np.int32))
    ops.reset_launches()
    with torch.no_grad():
        out = lm.prefill(dparams, toks.to(cuda), 80)
        want = lm.prefill(params, toks, 80)
        for step in range(len(nxt) + 1):
            torch.testing.assert_close(out[0].cpu(), want[0], atol=1e-3,
                                       rtol=1e-3)
            for k in ("k", "v"):
                assert out[1][k].dtype == torch.int8
                assert (out[1][k].cpu().int()
                        - want[1][k].int()).abs().max() <= 1
            for k in ("k_scale", "v_scale"):
                torch.testing.assert_close(out[1][k].cpu(), want[1][k],
                                           atol=0.0, rtol=TOL)
            if step < len(nxt):
                out = lm.decode_step(dparams, out[1], nxt[step].to(cuda))
                want = lm.decode_step(params, want[1], nxt[step])
    torch.cuda.synchronize()
    assert ops.FLASH_FORMS == {"tile": 2, "wgmma": 0, "split": 8}
    assert ops.LAUNCHES["flash_attention"] == 10


def test_qwen3_moe_layer_at_full_width_matches_the_cpu(cuda, monkeypatch):
    """qwen3-moe-235b-a22b at its published widths, 1 layer, fp32 -- GQA
    16:1, qk_norm, top-8 of 128 experts -- at B 2 x S 64: the prefill's
    logits and the loss and every gradient on the card against the same
    calls on the CPU (logits 1e-3; gradients 1e-3 of each leaf's largest
    magnitude, as smoke phase 11 (a)).  The routing of both sides is
    recorded: every card call's router probs are held within 1e-3 of
    `route` on the CPU at the same input, and a choice the card routes
    otherwise must be a near-tie (the CPU's probs of the two experts
    within 1e-3).  Where the two runs route otherwise, the card's
    dispatch/combine on its own routing is held against the same call on
    the CPU instead of what follows it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_paths

    cfg = get_config("qwen3-moe-235b-a22b").scaled(n_layers=1,
                                                   dtype="float32")
    lm = LM(cfg)
    dparams = lm.init(torch.Generator(device=cuda).manual_seed(43),
                      device=cuda)
    params = tree_map(lambda t: t.cpu(), dparams)
    calls = []
    route = moe.route

    def logged(p, x, c):
        out = route(p, x, c)
        calls.append((p, x.detach(), *(t.detach() for t in out)))
        return out

    monkeypatch.setattr(moe, "route", logged)
    rng = np.random.default_rng(43)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 64))
                            .astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))

    def routed_alike(n_card):
        """True when the card's and the CPU's calls routed alike; else
        the card's dispatch/combine holds on its own routing."""
        card, host = calls[:n_card], calls[n_card:]
        assert len(card) == len(host)
        alike = True
        for (p, x, probs, vals, idx), (*_, cidx) in zip(card, host):
            cp, cx, hidx = tree_map(lambda t: t.cpu(), p), x.cpu(), idx.cpu()
            with torch.no_grad():
                want_probs, _, want_idx = route(cp, cx, cfg)
            torch.testing.assert_close(probs.cpu(), want_probs, atol=1e-3,
                                       rtol=1e-3)
            moved = hidx != want_idx
            gap = (want_probs.gather(-1, hidx)
                   - want_probs.gather(-1, want_idx))[moved].abs()
            assert not gap.numel() or gap.max().item() <= 1e-3, \
                f"{int(moved.sum())} choices routed otherwise, not near-ties"
            if torch.equal(hidx, cidx) and not moved.any():
                continue
            alike = alike and torch.equal(hidx, cidx)
            with torch.no_grad():
                got = moe.dispatch_combine(p, x, vals, idx, cfg)
                want = moe.dispatch_combine(cp, cx, vals.cpu(), hidx, cfg)
            torch.testing.assert_close(got.cpu(), want, atol=1e-3,
                                       rtol=1e-3)
        calls.clear()
        return alike

    with torch.no_grad():
        got = lm.prefill(dparams, toks.to(cuda), 64)[0]
        n = len(calls)
        want = lm.prefill(params, toks, 64)[0]
    if routed_alike(n):
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    ops.reset_launches()
    (loss, aux), grads = loss_and_grads(lm, dparams, toks.to(cuda),
                                        labels.to(cuda))
    assert ops.LAUNCHES["flash_attention"] == 2
    assert ops.LAUNCHES["flash_attention_backward"] == 1
    n = len(calls)
    (want_loss, want_aux), want = loss_and_grads(lm, params, toks, labels)
    if routed_alike(n):
        torch.testing.assert_close(loss.cpu(), want_loss, atol=1e-3,
                                   rtol=1e-3)
        torch.testing.assert_close(aux["aux"].cpu(), want_aux["aux"],
                                   atol=1e-3, rtol=1e-3)
        for (path, g), (_, w) in zip(tree_paths(grads), tree_paths(want)):
            big = w.abs().max().item()
            torch.testing.assert_close(g.cpu(), w, atol=1e-3 * big,
                                       rtol=1e-3, msg=path)


def test_quickstart_filter_grad_runs_the_filter_grad_kernel(cuda):
    """The quickstart on the card: dx through the `cuda` backend's
    input_grad slot and dW through its filter_grad slot (the standalone
    zero-free dW kernel, launched at least once), both within 1e-4 of
    `naive` and of autograd of the plain conv (TF32 off)."""
    from repro_torch.examples import quickstart
    ops.reset_launches()
    res = quickstart.main([])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dconv_filter_grad"] >= 1
    assert ops.LAUNCHES["tconv_phase"] + \
        ops.LAUNCHES["tconv_implicit_gemm"] >= 1
    g = res["grads"]
    for name in ("dx", "dw"):
        for other in ("_naive", "_ref"):
            torch.testing.assert_close(g[name], g[name + other], atol=TOL,
                                       rtol=TOL)
    assert res["mapping_ok"] and res["drop_in"]["finite"]
    assert all(min(t.values()) > 0 for t in res["ms"].values())


def test_lm_trainer_run_on_a_side_stream_equals_the_default_stream(cuda):
    """`Trainer.run` inside `torch.cuda.stream(side)`: the prefetch
    thread's copy of each batch (`_put`) records an event on its own
    stream, and `_take` makes the step's stream wait on it.  Losses,
    params and optimizer state bit-equal to the same run on the default
    stream."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("qwen3-0.6b")

    def run():
        ds = TokenDataset(vocab=cfg.vocab, seq_len=64, global_batch=8,
                          seed=0)
        out = Trainer(cfg, ds, AdamWConfig(lr=3e-3, warmup_steps=0,
                                           total_steps=6),
                      TrainerConfig(total_steps=6, log_every=1),
                      device=cuda).run()
        torch.cuda.synchronize()
        return out

    want = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert len(got["history"]) == 6
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in want["history"]]
    for a, b in zip(tree_leaves({"p": got["params"], "o": got["opt"]}),
                    tree_leaves({"p": want["params"], "o": want["opt"]})):
        assert torch.equal(a, b)


# -- the trainer's compiled step (train/step_graph.py) ------------------------

_TRAINER_SIZES = {"cnn": dict(widths=(8, 16), image=16),
                  "gan_gen": dict(z_dim=16, base=8),
                  "gan": dict(z_dim=16, base=8)}


def _trainer(workload, device, injector=None, **kw):
    from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig
    base = dict(workload=workload, total_steps=4, batch=8, backend="cuda",
                ckpt_every=2, seed=0, **_TRAINER_SIZES[workload])
    base.update(kw)
    return ConvTrainer(ConvTrainerConfig(**base), injector=injector,
                       device=device)


def _eager_run(tr, lrs):
    """The trainer's steps eagerly (`build_step`) on its graph's stream,
    from its seeded init, at the learning rates `lrs`: (state, losses)."""
    from repro_torch.train.conv_trainer import _BATCH_KEYS
    fn, state = tr.build_step(guarded=True), tr.init_state()
    side, losses = tr.graph.stream, []
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i, lr in enumerate(lrs):
            b = tr.data.batch_at(i)
            data = tuple(torch.from_numpy(b[k]).to(tr.device)
                         for k in _BATCH_KEYS[tr.tcfg.workload])
            state, metrics, fin = fn(state, data, torch.tensor(
                lr, dtype=torch.float32, device=tr.device))
            assert fin.dtype == torch.bool and fin.is_cuda
            losses.append(float(metrics["loss"]))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return state, losses


def _assert_state_bit_equal(a, b):
    from repro_torch.models.layers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("workload", ["cnn", "gan_gen", "gan"])
def test_trainer_replays_equal_eager_steps(cuda, workload):
    """4 trainer steps (one capture, 4 replays) equal 4 eager steps on the
    same stream, losses and state bit for bit."""
    tr = _trainer(workload, cuda)
    out = tr.run()
    assert tr.captures == 1
    state, losses = _eager_run(tr, [0.05] * 4)
    _assert_state_bit_equal(out["state"], state)
    assert [h["loss"] for h in out["history"]] == losses


def test_one_capture_across_a_shrink_lr_retry_and_a_restore(cuda, tmp_path):
    from repro_torch.serve.faults import (FaultEvent, FaultInjector,
                                          FaultSchedule)
    inj = FaultInjector(FaultSchedule([FaultEvent("train.cnn", 1,
                                                  "nan_output"),
                                       FaultEvent("train.cnn", 2,
                                                  "nan_output")]))
    tr = _trainer("cnn", cuda, inj, ckpt_dir=str(tmp_path),
                  nonfinite_policy="shrink_lr", max_retries=3)
    out = tr.run()
    assert out["guard_stats"]["lr_shrinks"] == 1
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4]
    tr.tcfg.total_steps = 6             # the same trainer restores step 4
    out = tr.run()
    assert out["start_step"] == 4 and tr.captures == 1
    state, losses = _eager_run(tr, [0.05, 0.025, 0.05, 0.05, 0.05, 0.05])
    _assert_state_bit_equal(out["state"], state)
    assert [h["loss"] for h in out["history"]] == losses[4:]


@pytest.mark.parametrize("workload", ["cnn", "gan"])
def test_trainer_resume_bit_exact_on_the_card(cuda, workload, tmp_path):
    d = str(tmp_path)
    _trainer(workload, cuda, total_steps=2, ckpt_dir=d).run()
    out_r = _trainer(workload, cuda, ckpt_dir=d).run()
    assert out_r["start_step"] == 2
    out_s = _trainer(workload, cuda).run()
    _assert_state_bit_equal(out_r["state"], out_s["state"])
    assert out_r["history"] == out_s["history"][2:]


def test_async_checkpoints_during_replays_equal_blocking_ones(cuda,
                                                              tmp_path):
    """Every step checkpointed: the async writer snapshots the step's
    buffers before the next replay and commit overwrite them."""
    kw = dict(ckpt_every=1, keep_last=8, total_steps=6)
    out_a = _trainer("gan", cuda, ckpt_dir=str(tmp_path / "a"),
                     async_checkpoint=True, **kw).run()
    out_b = _trainer("gan", cuda, ckpt_dir=str(tmp_path / "b"), **kw).run()
    _assert_state_bit_equal(out_a["state"], out_b["state"])
    for step in range(1, 7):
        for i in range(8):
            leaf = f"step_{step}/leaf_{i}.npy"
            np.testing.assert_array_equal(np.load(tmp_path / "a" / leaf),
                                          np.load(tmp_path / "b" / leaf))


# -- phase 8's path and the planner on the card --------------------------------

@pytest.mark.parametrize("step", ["atrous_seg_loss", "segment_atrous_step",
                                  "patchify"])
def test_vision_launches(cuda, step):
    """The atrous loss, the example's step and patchify launch each kernel
    as chip_smoke.VISION_LAUNCHES says (held to `repro` on the CPU), at
    small widths, and hold their plain versions on the CPU within 1e-3."""
    from repro_torch.examples import segment_atrous as tex
    from repro_torch.models import vision
    from repro_torch.models.layers import sgd_grads, tree_leaves
    from repro_torch.optim import optimizer as opt

    table = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(table)
    table.loader.exec_module(mod)
    gen = torch.Generator().manual_seed(19)
    x, y = tex.synth_batch(0, batch=2, size=32)
    if step == "patchify":
        params = vision.patchify_init(gen, d_model=64, device="cpu")
        img = torch.randn((2, 56, 56, 3), generator=gen)

        def call(p, dev):
            return sgd_grads(lambda q: torch.sum(vision.patchify_apply(
                q, img.to(dev), backend="cuda") ** 2), p)
    else:
        params = vision.atrous_head_init(gen, device="cpu")
        cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, weight_decay=0.01)

        def call(p, dev):
            if step == "atrous_seg_loss":
                return sgd_grads(lambda q: vision.atrous_seg_loss(
                    q, x.to(dev), y.to(dev), backend="cuda"), p)
            return tex.make_step(cfg)(p, opt.adamw_init(p, cfg), x.to(dev),
                                      y.to(dev))
    on_card = {k: v.to(cuda) for k, v in params.items()}
    ops.reset_launches()
    got = call(on_card, cuda)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == \
        mod.VISION_LAUNCHES[step]
    want = call(params, torch.device("cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)


def test_planner_refuses_to_time_during_a_capture(cuda, tmp_path):
    from repro_torch.kernels import tiling

    spec = ConvSpec.make(stride=1, padding=2, filter_shape=3, dilation=2)
    x = torch.randn((2, 16, 16, 3), device=cuda)
    w = torch.randn((3, 3, 3, 8), device=cuda)
    ops.dconv_forward(x, w, stride=1, padding=2, dilation=2)  # built, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="captures a CUDA graph"):
        with torch.cuda.graph(graph):
            tiling.plan_tiles("forward", spec, x_shape=(2, 16, 16, 3),
                              dy_shape=(2, 16, 16, 8), mode="autotune",
                              tile_cache_path=tmp_path / "c.json")
    assert not (tmp_path / "c.json").exists()


# (op, strategy, spec (S, P, K, D), x_shape, dy_shape, epilogue kwargs)
RUNNER_CASES = [
    ("forward", "phase", (1, 2, 3, 2), (2, 20, 20, 3), (2, 20, 20, 16),
     dict(activation="relu")),
    ("input_grad", "phase", (2, 1, 4, 1), (4, 8, 8, 64), (4, 4, 4, 128),
     dict(activation="relu")),
    ("input_grad", "implicit_gemm", (2, 1, 4, 1), (4, 8, 8, 64),
     (4, 4, 4, 128), dict(activation="relu", bias=True)),
    ("input_grad", "implicit_gemm", (1, 4, 3, 4), (2, 17, 17, 8),
     (2, 17, 17, 24), None),
    ("backward", "phase", (1, 4, 3, 4), (4, 32, 32, 3), (4, 32, 32, 16),
     dict(activation="relu")),
    ("backward", "phase", (14, 0, 14, 1), (2, 56, 56, 3), (2, 4, 4, 64),
     None),
    ("ct_backward", "phase", (2, 1, 4, 1), (4, 16, 16, 32), (4, 8, 8, 64),
     dict(activation="tanh", bias=True)),
    ("filter_grad", "phase", (2, 1, 3, 1), (4, 17, 17, 8), (4, 9, 9, 40),
     None),
]


@pytest.mark.parametrize("case", RUNNER_CASES,
                         ids=[f"{c[0]}_{c[1]}_{i}"
                              for i, c in enumerate(RUNNER_CASES)])
def test_autotune_runners_agree_with_the_analytical_plan(cuda, case):
    """Every candidate the planner would time gives the analytical plan's
    output within 1e-4 through its kernel's registered runner."""
    from repro_torch.kernels import tiling

    op, strategy, (s, p, k, d), xs, ds, ep_kw = case
    spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    ep = None if ep_kw is None else Epilogue(**ep_kw)
    run = tiling._RUNNERS[(op, strategy)](spec, xs, ds, epilogue=ep)
    plans = tiling._candidates(op, spec, xs, ds, ep, strategy)
    assert plans[0] == tiling.plan_strategy(
        op, spec, x_shape=xs, dy_shape=ds, epilogue=ep, strategy=strategy,
        mode="analytical")[1]
    want = run(plans[0])
    for plan in plans:
        got = run(plan)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if b is not None:
                torch.testing.assert_close(a, b, atol=TOL, rtol=TOL,
                                           msg=lambda m: f"{plan}: {m}")


def test_musicgen_trainer_step_at_full_width_matches_the_cpu(cuda, tmp_path):
    """musicgen-medium at its published widths (d 1536, 24 heads of 64,
    ungated gelu, vocab 2048), 2 layers, fp32, inputs that are frame
    embeddings: one `Trainer` step on the card from the same checkpoint
    as one on the CPU -- the prefetcher moves (B, S, D) float batches --
    with the loss within 1e-3 and every param within 1e-4 of the lr of
    the CPU's.  AdamW's eps is 1e-3, so a step is near-linear in its
    gradient and the comparison does not sit on the sign of gradients
    near zero."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("musicgen-medium").scaled(n_layers=2, dtype="float32")
    opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=1, eps=1e-3)
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(tmp_path / "cpu"), 0,
              {"params": params, "opt": adamw_init(params, opt)})
    shutil.copytree(tmp_path / "cpu", tmp_path / "card")

    def run(d, device):
        ds = TokenDataset(vocab=cfg.vocab, seq_len=128, global_batch=4,
                          seed=0, embed_dim=cfg.d_model)
        return Trainer(cfg, ds, opt, TrainerConfig(
            total_steps=1, ckpt_dir=str(d), log_every=1,
            async_checkpoint=False), device=device).run()

    ops.reset_launches()
    got = run(tmp_path / "card", cuda)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2 * 2 * 4     # remat, 4 micro
    assert ops.LAUNCHES["flash_attention_backward"] == 2 * 4
    want = run(tmp_path / "cpu", "cpu")
    assert abs(got["history"][0]["loss"] - want["history"][0]["loss"]) \
        <= 1e-3 * abs(want["history"][0]["loss"])
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        assert torch.allclose(a.cpu(), b, atol=1e-4 * opt.lr, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_two_gloo_ranks_on_the_card_equal_one_rank(cuda, tmp_path, shape):
    """The CNN `sgd_step` on a 2-rank mesh (`gloo` ranks sharing the
    card; the batch over "data" or the channels over "model") against
    the same step on one rank: params within rtol 2e-4 / atol 2e-5, the
    loss within 1e-5 (`repro`'s bounds), and one forward and one backward
    launch per conv layer on each rank."""
    import torch.multiprocessing as mp

    import _torch_mesh
    mp.spawn(_torch_mesh.card_worker, args=(str(tmp_path), shape), nprocs=2,
             join=True)
    for rank in range(2):
        res = torch.load(tmp_path / f"card_{rank}.pt", weights_only=False)
        assert res["launches"] == {"dconv_forward": 2, "conv_backward": 2}
        assert res["loss_err"] <= 1e-5
        assert len(res["close"]) == 3 and all(res["close"])


def test_two_gloo_ranks_serve_and_train_the_lm_on_the_card(cuda, tmp_path):
    """qwen3's SMOKE config in fp32 on a (1, 2) mesh of `gloo` ranks
    sharing the card (`_torch_mesh_lm.card_worker`): the prefill and 6
    decodes in the serve layout within 1e-4 of one rank, one
    flash-attention launch per layer per call on each rank -- none on
    the second sequence block's rank until its first key (the 4th
    decode: 5 + 3 positions fill the first block of 8) -- and the loss
    (1e-5 relative) and every gradient (1e-3 of the leaf's max) in the
    training layout, with one forward per layer twice (remat) and one
    backward per layer."""
    import torch.multiprocessing as mp

    import _torch_mesh_lm
    mp.spawn(_torch_mesh_lm.card_worker, args=(str(tmp_path),), nprocs=2,
             join=True)
    for rank in range(2):
        res = torch.load(tmp_path / f"card_{rank}.pt", weights_only=False)
        assert res["logits_err"] <= 1e-4, res
        assert res["launches"] == ([2] * 7 if rank == 0
                                   else [2, 0, 0, 0, 2, 2, 2]), res
        assert res["loss_err"] <= 1e-5 and res["grad_err"] <= 1e-3, res
        assert res["train_launches"] == {"flash_attention": 4,
                                         "flash_attention_backward": 2}


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "zamba2_2_7b"])
def test_two_gloo_ranks_run_a_moe_and_a_hybrid_lm_on_the_card(cuda, tmp_path,
                                                               arch):
    """A MoE (moonshot, shared experts) and a hybrid (zamba2, its shared
    block before each of 2 groups) SMOKE config in fp32 on a (1, 2) mesh
    of `gloo` ranks sharing the card (`_torch_mesh_families.card_worker`):
    the loss and MoE aux (1e-5 relative) and every gradient (1e-3 of the
    leaf's max) in the training layout, with one forward per attention
    layer twice (remat) and one backward; the prefill and 6 decodes in
    the serve layout, logits and every cache entry within 1e-4 of one
    rank, one launch per attention layer per call on each rank -- none
    on the second sequence block's rank until its first key (the 4th
    decode)."""
    import torch.multiprocessing as mp

    import _torch_mesh_families
    mp.spawn(_torch_mesh_families.card_worker, args=(str(tmp_path), arch),
             nprocs=2, join=True)
    n_attn = 2      # moonshot's 2 layers; zamba2's 2 groups
    for rank in range(2):
        res = torch.load(tmp_path / f"card_{rank}.pt", weights_only=False)
        assert res["loss_err"] <= 1e-5 and res["aux_err"] <= 1e-5, res
        assert res["grad_err"] <= 1e-3, res
        assert res["train_launches"] == {
            "flash_attention": 2 * n_attn,
            "flash_attention_backward": n_attn}, res
        assert res["logits_err"] <= 1e-4 and res["cache_err"] <= 1e-4, res
        assert res["launches"] == ([n_attn] * 7 if rank == 0 else
                                   [n_attn, 0, 0, 0, n_attn, n_attn,
                                    n_attn]), res


# -- conv_backward's patch roles (non-overlapping convs) -------------------------

# (name, B, (H, W), Cin, Cout, K) at S = K, P = 0, D = 1: patchify's layer
# at batch 2 (3 -> 1024, S = K = 14); a 15 x 15 frame that S = K = 4 does
# not divide (dx = 0 on its last 3 rows and columns) at Cout 32 and 8
# (below PATCH_MIN_COUT: the patch plan is forced there); S = K = 2 on a
# 17 x 16 frame with ragged channels; a 1x1 conv at S = 1; a run of
# Kw*Cin = 390 values, longer than the 128-row tile.
PATCH_CASES = [
    ("patchify_b2", 2, (448, 448), 3, 1024, 14),
    ("s4_frame15_cout32", 2, (15, 15), 3, 32, 4),
    ("s4_frame15_cout8", 2, (15, 15), 3, 8, 4),
    ("s2_ragged", 3, (17, 16), 5, 37, 2),
    ("conv1x1_s1", 4, (20, 20), 48, 64, 1),
    ("s3_run390", 2, (10, 9), 130, 37, 3),
]


def _patch_split_plan(spec, B, oh_ow, cin, cout, bias):
    """The patch plan with both reductions split, as far as each length
    leaves no split empty: dx over Cout in two, dW's positions in four."""
    positions = B * oh_ow[0] * oh_ow[1]
    splits = 2 if cout > split_chunk(cout, 2) else 1
    dw = next(d for d in (4, 2, 1)
              if d == 1 or (d - 1) * split_chunk(positions, d) < positions)
    return counted("conv_backward", spec, B, oh_ow, cin, cout, PATCH, splits,
                   PATCH, dw, bias=bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", PATCH_CASES, ids=lambda c: c[0])
def test_conv_backward_patch_roles_match_plain(cuda, case, dtype):
    """The patch roles against conv_backward_plain under each epilogue of
    EP_KW, at `plan`'s patch plan (forced below PATCH_MIN_COUT) and with
    both reductions split: fp32 within TOL, bf16 within one bf16 ulp
    (rtol 2^-7, atol 2^-7 of the largest magnitude).  Through the wrapper
    one launch a call; reruns bit-equal; dx exactly 0 where no patch
    covers the frame."""
    name, B, (H, W), cin, cout, k = case
    spec = ConvSpec.make(stride=k, padding=0, filter_shape=k)
    oh, ow = spec.out_size((H, W))
    gen = torch.Generator().manual_seed(len(name))
    x = _rand(gen, B, H, W, cin, device=cuda).to(dtype)
    w = _rand(gen, k, k, cin, cout, device=cuda).to(dtype)
    dy = (_rand(gen, B, oh, ow, cout, device=cuda)
          / (B * oh * ow) ** 0.5).to(dtype)
    for kw in EP_KW:
        ep = Epilogue(**(kw or {}))
        y = _rand(gen, B, oh, ow, cout, device=cuda)
        y = (torch.tanh(y) if ep.activation == "tanh" else y).to(dtype)
        y = y if ep.needs_y else None
        want = conv_backward_plain(x, dy, w, spec, n_out=(H, W), y=y,
                                   epilogue=ep)
        planned = backward_plan("conv_backward", spec, B, (H, W), (oh, ow),
                                cin, cout, n_out=(H, W), bias=ep.bias)
        assert (planned.tile == PATCH) == (cout >= 16)
        plans = [patch_plan(spec, B, (oh, ow), cin, cout, ep.bias),
                 _patch_split_plan(spec, B, (oh, ow), cin, cout, ep.bias)]
        for p in plans:
            runs = [conv_backward_cuda(x, dy, w, spec, n_out=(H, W), y=y,
                                       epilogue=ep, plan=p)
                    for _ in range(2)]
            for a, b in zip(runs[0], want):
                if b is None:
                    assert a is None
                    continue
                assert a.dtype == b.dtype and a.shape == b.shape
                if dtype == torch.float32:
                    torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
                else:
                    scale = float(b.float().abs().max())
                    torch.testing.assert_close(
                        a.float(), b.float(), rtol=BF16_ULP,
                        atol=BF16_ULP * scale)
            dx = runs[0][0]
            assert not dx[:, oh * k:].any() and not dx[:, :, ow * k:].any()
            assert all(torch.equal(a, b) for a, b in zip(*runs)
                       if a is not None)
        if planned.tile == PATCH:
            ops.reset_launches()
            ops.conv_backward(x, dy, w, stride=k, padding=0, n_out=(H, W),
                              y=y, epilogue=ep)
            assert ops.LAUNCHES["conv_backward"] == 1
            assert sum(ops.LAUNCHES.values()) == 1


def test_conv_backward_refuses_a_patch_plan_of_an_overlapping_conv(cuda):
    """The C entry takes tile 5 only for S = K, P = 0, D = 1 and for both
    roles at once: an S = 2, K = 4 conv, or a patch plan mixing tiles, is
    refused before anything runs."""
    gen = torch.Generator().manual_seed(5)
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    x = _rand(gen, 2, 8, 8, 3, device=cuda)
    w = _rand(gen, 4, 4, 3, 32, device=cuda)
    dy = _rand(gen, 2, 4, 4, 32, device=cuda)
    bad = BackwardPlan(PATCH, 1, PATCH, 1, 32, 1, 1, 0, 0)
    with pytest.raises(RuntimeError, match="conv_backward kernel launch"):
        conv_backward_cuda(x, dy, w, spec, n_out=(8, 8), plan=bad)
    patch = ConvSpec.make(stride=4, padding=0, filter_shape=4)
    mixed = BackwardPlan(PATCH, 1, 2, 1, 16, 1, 1, 0, 0)
    with pytest.raises(RuntimeError, match="conv_backward kernel launch"):
        conv_backward_cuda(x, _rand(gen, 2, 2, 2, 32, device=cuda), w,
                           patch, n_out=(8, 8), plan=mixed)


# -- the conv kernels in bf16 ---------------------------------------------------

BF16_ULP = 2.0 ** -7   # rtol, and atol times the output's largest magnitude
# (kernel, BACKWARD_GRID case): ragged channels (Cin 29 / Cout 21, Cin 130),
# a dilated atrous geometry and residues no tap reaches (K < S).
BF16_CASES = [(kernel, geom) for kernel in (
    "dconv_forward", "tconv_phase", "tconv_implicit_gemm", "conv_backward",
    "tconv_backward", "dconv_filter_grad") for geom in (
    "s2_ragged", "ragged_cin_gt_tile", "s1_d2_atrous", "s4_klt_s")]


def _bf16_call(kernel, c):
    """(kernel call, plain call) of one BACKWARD_GRID case in bf16, with
    the leaky / bias / scale epilogue where the kernel takes one."""
    spec = _spec(c)
    ep = Epilogue(**EP_KW[2])
    t = {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
         for k, v in c.items()}
    geo = dict(stride=spec.stride, padding=spec.padding,
               dilation=spec.dilation)
    y = t["y"].where(t["y"] > 0, 0.2 * t["y"])   # a leaky_relu output
    z = t["z"].where(t["z"] > 0, 0.2 * t["z"])
    if kernel == "dconv_forward":
        return (lambda: ops.dconv_forward(t["x"], t["w"], bias=t["b_out"],
                                          epilogue=ep, **geo),
                lambda: dconv_forward_plain(t["x"], t["w"], spec,
                                            bias=t["b_out"], epilogue=ep))
    if kernel in ("tconv_phase", "tconv_implicit_gemm"):
        strategy = "phase" if kernel == "tconv_phase" else "implicit_gemm"
        plain = tconv_fused_plain if kernel == "tconv_phase" \
            else tconv_implicit_gemm_plain
        return (lambda: ops.tconv_phase(t["dy"], t["w"], n_out=c["n"],
                                        bias=t["b_in"], epilogue=ep,
                                        strategy=strategy, **geo),
                lambda: plain(t["dy"], t["w"], spec, n_out=c["n"],
                              bias=t["b_in"], epilogue=ep))
    if kernel == "conv_backward":
        return (lambda: ops.conv_backward(t["x"], t["dy"], t["w"],
                                          n_out=c["n"], y=y, epilogue=ep,
                                          **geo),
                lambda: conv_backward_plain(t["x"], t["dy"], t["w"], spec,
                                            n_out=c["n"], y=y, epilogue=ep))
    if kernel == "tconv_backward":
        return (lambda: ops.tconv_backward(t["g"], t["dy"], t["w"], z=z,
                                           epilogue=ep, **geo),
                lambda: tconv_backward_plain(t["g"], t["dy"], t["w"], spec,
                                             z=z, epilogue=ep))
    return (lambda: ops.dconv_filter_grad(t["x"], t["dy"],
                                          k=spec.filter_shape, **geo),
            lambda: dconv_filter_grad_plain(t["x"], t["dy"], spec))


def _outputs(out):
    return tuple(o for o in out if o is not None) \
        if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel,name", BF16_CASES,
                         ids=[f"{k}-{g}" for k, g in BF16_CASES])
def test_conv_kernels_in_bf16_match_plain(cuda, kernel, name):
    """Each conv kernel's `_bf16` entry: bf16 outputs (repro's dtypes)
    within one bf16 ulp of the plain version on the same card (both round
    once from fp32 sums that differ only in order), one launch counted
    in LAUNCHES, and a rerun bit-equal to the first run."""
    geom = next(g for g in BACKWARD_GRID if g[0] == name)
    run, plain = _bf16_call(kernel, _cuda_case(geom, 21, cuda))
    ops.reset_launches()
    got = _outputs(run())
    assert ops.LAUNCHES[kernel] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    want = _outputs(plain())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a.float()).all()
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16_ULP,
                                   atol=BF16_ULP * scale)
    assert all(torch.equal(a, b) for a, b in zip(got, _outputs(run())))


def test_bf16_and_fp32_plans_take_separate_cache_entries(cuda, tmp_path):
    """One geometry autotuned in fp32 and in bf16: two rows under two keys
    (|w4, |w2), each replayed from its own row, and the bf16 sweep timed
    on bf16 inputs (its plan's output is bf16)."""
    from repro_torch.kernels import tiling

    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    xs, ds = (4, 16, 16, 32), (4, 8, 8, 64)
    path = tmp_path / "c.json"
    tiling._MEM_CACHE.clear()
    plans = {dt: tiling.plan_tiles("ct_backward", spec, x_shape=xs,
                                   dy_shape=ds, mode="autotune",
                                   tile_cache_path=path, dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
    keys = {dt: tiling._cache_key("ct_backward", spec, xs, ds, None, "phase",
                                  dt) for dt in plans}
    assert keys[torch.float32] != keys[torch.bfloat16]
    assert "|w4|" in keys[torch.float32] and "|w2|" in keys[torch.bfloat16]
    import json
    rows = json.loads(path.read_text())
    assert set(keys.values()) <= set(rows)
    tiling._MEM_CACHE.clear()
    for dt, plan in plans.items():
        assert tiling.plan_tiles("ct_backward", spec, x_shape=xs,
                                 dy_shape=ds, mode="autotune",
                                 tile_cache_path=path, dtype=dt) == plan
    run = tiling._RUNNERS[("ct_backward", "phase")](
        spec, xs, ds, epilogue=None, dtype=torch.bfloat16)
    assert all(o.dtype == torch.bfloat16
               for o in _outputs(run(plans[torch.bfloat16])))
    tiling._MEM_CACHE.clear()


@pytest.mark.parametrize("step", ["sgd_step", "gan_sgd_step"])
def test_bf16_training_step_launches_the_bf16_kernels(cuda, step):
    """A bf16 step at the published widths, batch 8 (every param and the
    batch cast to bf16), launches the fp32 step's kernels, as many of
    each, and returns bf16."""
    gen = torch.Generator().manual_seed(3)
    bf = lambda tree: tree_map(lambda t: t.to(torch.bfloat16), tree)
    if step == "sgd_step":
        p = bf(cnn.simple_cnn_init(gen, device=cuda))
        b = ConvDataset(kind="cnn", batch=8, image=32, seed=0).batch_at(0)
        x = torch.from_numpy(b["x"]).to(cuda, torch.bfloat16)
        ops.reset_launches()
        new, loss = cnn.sgd_step(p, x, torch.from_numpy(b["labels"]).to(cuda),
                                 backend="cuda")
        outs = [loss] + L.tree_leaves(new)
    else:
        st = bf(gan.gan_init(gen, device=cuda))
        b = ConvDataset(kind="gan", batch=8, z_dim=64, seed=0).batch_at(0)
        ops.reset_launches()
        new, g_loss, d_loss = gan.gan_sgd_step(
            st, torch.from_numpy(b["z"]).to(cuda, torch.bfloat16),
            torch.from_numpy(b["real"]).to(cuda, torch.bfloat16),
            backend="cuda")
        outs = [g_loss, d_loss] + L.tree_leaves(new)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert launches == _step_launches()[step]
    assert all(o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
               for o in outs)


# -- the decode step compiled once (serve/decode_graph.py) ---------------------

# (extent, cache length) of the split form with a device length: a
# bucket's first, middle and last positions, and lengths that leave
# whole splits empty in a long bucket.
DEVICE_LEN_CASES = [(64, 0), (64, 31), (64, 63), (1024, 512), (1024, 1023),
                    (2048, 1024), (2048, 2047), (2048, 5), (1024, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Hq,Hk,D", [(16, 8, 128), (32, 32, 80)])
@pytest.mark.parametrize("extent,n", DEVICE_LEN_CASES)
def test_split_form_with_a_device_length_matches_plain(cuda, dtype, Hq, Hk,
                                                       D, extent, n):
    """The split form reading the cache length from the card, over the
    bucket view cache[:, :extent] of a (4, 2048) cache, against the
    plain version over the live prefix (and over the view with the same
    device length); one launch counted as a device-length launch;
    reruns bit-equal; the int form at the same live length agrees."""
    gen = torch.Generator().manual_seed(extent + n)
    q = _rand(gen, 4, 1, Hq, D, device=cuda).to(dtype)
    k = _rand(gen, 4, 2048, Hk, D, device=cuda).to(dtype)
    v = _rand(gen, 4, 2048, Hk, D, device=cuda).to(dtype)
    length = torch.tensor(n, dtype=torch.int32, device=cuda)
    kb, vb = k[:, :extent], v[:, :extent]
    ops.reset_launches()
    got = ops.flash_attention(q, kb, vb, causal=True, length=length)
    torch.cuda.synchronize()
    assert ops.FLASH_DEVICE_LEN == {"split": 1}
    assert ops.FLASH_FORMS == {"tile": 0, "wgmma": 0, "split": 1}
    atol, rtol = ATTN_TOL[dtype]
    want = flash_attention_plain(q, k[:, :n + 1], v[:, :n + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    view = flash_attention_plain(q, kb, vb, causal=True, length=length)
    torch.testing.assert_close(got.float(), view.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, ops.flash_attention(q, kb, vb, causal=True,
                                                length=length))
    int_form = ops.flash_attention(q, k[:, :n + 1], v[:, :n + 1],
                                   causal=True)
    torch.testing.assert_close(got.float(), int_form.float(), atol=atol,
                               rtol=rtol)


def test_split_form_refuses_a_device_length_elsewhere(cuda):
    """The C entry takes a device length for the split form only."""
    q = torch.zeros((1, 64, 4, 64), device=cuda, dtype=torch.bfloat16)
    length = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="split form"):
        flash_attention_cuda(q, q, q, causal=True, q_offset=0,
                             form=AttentionPlan("wgmma", 1), length=length)
    with pytest.raises(ValueError, match="split form"):
        ops.flash_attention(q, q, q, length=length)


DECODE_FAMILIES = [("qwen3_0_6b", {}), ("qwen3_0_6b", {"kv_quant": True}),
                   ("moonshot_v1_16b_a3b", {}), ("rwkv6_7b", {}),
                   ("zamba2_2_7b", {})]


def _clone(cache):
    return {k: t.clone() if isinstance(t, torch.Tensor) else t
            for k, t in cache.items()}


@pytest.mark.parametrize("arch,kw", DECODE_FAMILIES,
                         ids=["dense", "int8", "moe", "ssm", "hybrid"])
def test_decode_graph_replays_equal_the_eager_graph_form(cuda, arch, kw):
    """Each family's SMOKE config (fp32) through DecodeGraph over steps
    that cross a bucket edge (prompt 60, max_len 160: extents 64, 128):
    every step's logits bit-equal to the same graph-form step run eagerly
    on a copy of the cache on the graph's stream, and within 1e-4 of the
    int form (its own split count; the int8 codes 1 apart at a tie);
    one capture per bucket touched (rwkv6, with no attention: one graph),
    none more on a rerun from the same prefill; each replay counted as an
    eager step's launches in `replay_launches`."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch).scaled(dtype="float32", **kw)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(40), device=cuda)
    rng = np.random.default_rng(40)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 60))
                              .astype(np.int32)).to(cuda)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (6, 2))).to(cuda)
    graph = DecodeGraph(lm, params, 2, 160, cuda)
    with torch.no_grad():
        _, cache = lm.prefill(params, prompt, 160)
        touched = set()
        for run in range(2):
            graph.load(cache)
            icache = _clone(cache)
            for t in toks:
                n, extent = graph.host_len, graph.extent()
                touched.add(extent)
                copy = _clone(graph.cache)
                got = graph.step(t)[0].clone()
                graph.stream.wait_stream(torch.cuda.current_stream())
                before = ops.LAUNCHES["flash_attention"]
                with torch.cuda.stream(graph.stream):
                    want, copy = lm.decode_step(params, copy, t[:, None],
                                                extent=extent)
                per_step = ops.LAUNCHES["flash_attention"] - before
                torch.cuda.current_stream().wait_stream(graph.stream)
                assert torch.equal(got, want), (run, n)
                assert int(graph.cache["len"]) == int(copy["len"]) == n + 1
                ilog, icache = lm.decode_step(params, icache, t[:, None])
                torch.testing.assert_close(got, ilog, atol=TOL, rtol=TOL)
            assert touched == ({64, 128} if "k" in cache else {160})
            assert graph.captures == len(touched) == len(graph.graphs)
    replays = 2 * len(toks) - graph.captures
    assert graph.replay_launches == (
        {"flash_attention": per_step * replays} if per_step else {})
    for name in (k for k in icache if k != "len"):
        if icache[name].dtype == torch.int8:
            assert (icache[name].int() - graph.cache[name].int()).abs() \
                .max() <= 1
        else:
            torch.testing.assert_close(graph.cache[name], icache[name],
                                       atol=TOL, rtol=TOL)


def test_decode_graph_capture_that_syncs_with_the_host_raises(cuda,
                                                              monkeypatch):
    """A step that reads a device value back to the host runs eagerly
    (the bucket's first step) but cannot be captured: the capture raises,
    and no graph is kept."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=64,
                      d_ff=128, vocab=97, n_heads=4, n_kv_heads=2,
                      head_dim=16, dtype="float32")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(41), device=cuda)
    graph = DecodeGraph(lm, params, 2, 64, cuda)
    with torch.no_grad():
        graph.load(lm.prefill(params, torch.ones((2, 5), dtype=torch.int32,
                                                 device=cuda), 64)[1])
        real = L.rmsnorm

        def syncing(p, x, eps=1e-6):
            if float(x.float().abs().max()) < 0:     # a host read
                raise AssertionError
            return real(p, x, eps)

        monkeypatch.setattr(L, "rmsnorm", syncing)
        with pytest.raises(RuntimeError):
            graph.step(torch.ones(2, dtype=torch.int64, device=cuda))
    assert graph.captures == 0 and not graph.graphs
    torch.cuda.synchronize()
