"""The port's CUDA kernels on the card: each held against its plain PyTorch
version, plus the wrappers' launch counts and refusals.

These tests need a CUDA card and skip without one.  They import no JAX
(the card's machine has none), so they run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4; kernel and plain version both sum in fp32
and differ only in summation order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_cases import EP_KW, FWD_GRID, TCONV_GRID, tconv_case
from repro_torch.core.conv import ecoflow_conv_transpose
from repro_torch.core.spec import ConvSpec, Epilogue, resolve_backend
from repro_torch.kernels import ops
from repro_torch.kernels.dconv_forward import dconv_forward_plain
from repro_torch.kernels.implicit_gemm import tconv_implicit_gemm_plain
from repro_torch.kernels.tconv_phase import tconv_fused_plain

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


def test_each_wrapper_counts_its_launches(cuda):
    gen = torch.Generator().manual_seed(5)
    dy = _rand(gen, 2, 4, 4, 8, device=cuda)
    ops.reset_launches()
    ops.tconv_phase(dy, _rand(gen, 4, 4, 16, 8, device=cuda), stride=2,
                    padding=1, n_out=(8, 8))              # Cin 16: phase
    ops.tconv_phase(dy, _rand(gen, 4, 4, 3, 8, device=cuda), stride=2,
                    padding=1, n_out=(8, 8))              # Cin 3: implicit
    ops.dconv_forward(_rand(gen, 1, 8, 8, 3, device=cuda),
                      _rand(gen, 3, 3, 3, 4, device=cuda), stride=1,
                      padding=2, dilation=2)
    assert ops.LAUNCHES == {"dconv_forward": 1, "tconv_phase": 1,
                            "tconv_implicit_gemm": 1}
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
    be = resolve_backend("cuda")
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    x = torch.zeros((1, 8, 8, 3), device=cuda)
    dy = torch.zeros((1, 4, 4, 5), device=cuda)
    w = torch.zeros((4, 4, 3, 5), device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        be.filter_grad(x, dy, spec)
    with pytest.raises(NotImplementedError, match="training slice"):
        be.backward(x, dy, w, spec, (8, 8))
    with pytest.raises(NotImplementedError):
        ecoflow_conv_transpose(dy, w.requires_grad_(), 2, 1, backend="cuda")


def test_engine_on_the_card_has_no_plain_rung(cuda):
    from repro_torch.serve.conv_engine import DEFAULT_LADDER, ConvServeEngine
    assert ConvServeEngine(device=cuda).ladder == ("cuda",)
    with pytest.raises(ValueError, match="kernels alone"):
        ConvServeEngine(device=cuda, ladder=DEFAULT_LADDER)
