"""The port's dense zero-free ops and phase bookkeeping on the CPU against
`repro`: `core/ecoflow.py` (the torch_zero_free backend), the reference
backend, the oracles of `kernels/ref.py`, `kernels/tap_gather.py` and the
phase packing and assembly helpers of `kernels/tconv_phase.py`.  Inputs
come from numpy seeds; fp32 at rtol = atol = 1e-4 (DESIGN.md Sec. 2.3).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import FWD_GRID, TCONV_GRID, tconv_case
from conftest import assert_allclose
from repro.core import ecoflow as jeco
from repro.core import spec as jspec
from repro.kernels import tap_gather as jtap
from repro.kernels import tconv_phase as jtp
from repro_torch.core import ecoflow as teco
from repro_torch.core import spec as tspec
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tap_gather as ttap
from repro_torch.kernels import tconv_phase as ttp


@pytest.mark.parametrize("geom", TCONV_GRID)
def test_tconv_dense_ops_match_repro(geom):
    """torch_zero_free's dense transposed conv, the reference backend's
    input gradient and the oracle, against `repro`'s dense form."""
    spec, n_out, dy, w, _ = tconv_case(geom, 1)
    kw = dict(stride=spec.stride, padding=spec.padding, n_out=n_out,
              dilation=spec.dilation)
    want = jeco.transposed_conv_zero_free(jnp.asarray(dy), jnp.asarray(w),
                                          **kw)
    assert_allclose(teco.transposed_conv_zero_free(
        torch.tensor(dy), torch.tensor(w), **kw), want)
    assert_allclose(tref.tconv_phase_ref(torch.tensor(dy), torch.tensor(w),
                                         **kw), want)
    assert_allclose(tspec.resolve_backend("reference").input_grad(
        torch.tensor(dy), torch.tensor(w), spec, n_out), want)


@pytest.mark.parametrize("geom", FWD_GRID)
def test_forward_dense_ops_match_repro(geom):
    """The oracle, torch_zero_free's dilated forward and its filter
    gradient against `repro`'s dense forms."""
    s, d, k, p = geom
    spec = tspec.ConvSpec.make(stride=s, padding=p, filter_shape=k,
                               dilation=d)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 9, 3)).astype(np.float32)
    w = rng.standard_normal(spec.filter_shape + (3, 5)).astype(np.float32)
    ref = jeco.direct_conv(jnp.asarray(x), jnp.asarray(w), s, p, dilation=d)
    assert_allclose(tref.dconv_forward_ref(torch.tensor(x), torch.tensor(w),
                                           stride=s, padding=p, dilation=d),
                    ref)
    assert_allclose(teco.dilated_forward_zero_free(
        torch.tensor(x), torch.tensor(w), stride=s, padding=p, dilation=d),
        ref)
    dy = rng.standard_normal(ref.shape).astype(np.float32)
    assert_allclose(
        teco.dilated_conv_filter_grad_zero_free(
            torch.tensor(x), torch.tensor(dy), stride=s, padding=p,
            k=spec.filter_shape, dilation=d),
        jeco.dilated_conv_filter_grad_zero_free(
            jnp.asarray(x), jnp.asarray(dy), stride=s, padding=p,
            k=spec.filter_shape, dilation=d))


@pytest.mark.parametrize("s,d,k", [(2, 1, 4), (3, 1, 2), (2, 2, 3),
                                   (3, 2, 4), ((2, 3), (1, 2), (3, 2))])
def test_phase_packing_and_subfilters_match_repro(s, d, k):
    spec = tspec.ConvSpec.make(stride=s, filter_shape=k, dilation=d)
    rng = np.random.default_rng(5)
    w = rng.standard_normal(spec.filter_shape + (3, 2)).astype(np.float32)
    assert_allclose(ttp.pack_phase_filters(torch.tensor(w), s, d),
                    jtp.pack_phase_filters(jnp.asarray(w), s, d))
    for t_row, j_row in zip(teco.phase_subfilters(torch.tensor(w), s),
                            jeco.phase_subfilters(jnp.asarray(w), s)):
        for t_sub, j_sub in zip(t_row, j_row):
            assert tuple(t_sub.shape) == tuple(j_sub.shape)
            assert_allclose(t_sub, j_sub)


@pytest.mark.parametrize("geom", [TCONV_GRID[2], TCONV_GRID[4],
                                  TCONV_GRID[6]])
@pytest.mark.parametrize("with_fill", [False, True])
def test_assemble_phase_major_matches_repro(geom, with_fill):
    """Residue placement, sentinel fill planes, crop and tail fill, on
    geometries where residues go unreached and n_out is non-exact."""
    spec, n_out, dy, _, _ = tconv_case(geom, 6)
    js = jspec.ConvSpec.make(stride=spec.stride, padding=spec.padding,
                             filter_shape=spec.filter_shape,
                             dilation=spec.dilation)
    fh, fw = spec.full_size(dy.shape[1:3])
    ho, wo = -(-fh // spec.stride[0]), -(-fw // spec.stride[1])
    t = spec.n_tap_phases[0] * spec.n_tap_phases[1]
    rng = np.random.default_rng(7)
    out = rng.standard_normal((2, t, ho, wo, 3)).astype(np.float32)
    fill = rng.standard_normal(3).astype(np.float32) if with_fill else None
    got = ttp.assemble_phase_major(
        torch.tensor(out), spec, n_out=n_out, full_size=(fh, fw),
        fill=None if fill is None else torch.tensor(fill))
    want = jtp.assemble_phase_major(
        jnp.asarray(out), js, n_out=n_out, full_size=(fh, fw),
        fill=None if fill is None else jnp.asarray(fill))
    assert tuple(got.shape) == tuple(want.shape)
    assert_allclose(got, want)


def test_tap_gather_matches_repro():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((9, 10, 3)).astype(np.float32)
    geo = dict(sh=2, sw=1, dh=2, dw=3, oh=3, ow=4)
    for kx, ky in [(0, 0), (1, 2), (2, 1)]:
        assert_allclose(ttap.gather_tap(torch.tensor(x), kx, ky, **geo),
                        jtap.gather_tap(jnp.asarray(x), kx, ky, **geo))
    assert ttap.tap_window_extent(4, 2, 3, 3) == \
        jtap.tap_window_extent(4, 2, 3, 3)
    xp = rng.standard_normal((1, 5, 6, 2)).astype(np.float32)
    pad = dict(stride=(2, 1), dilation=(2, 2), k=(3, 3), out_size=(3, 4))
    assert_allclose(ttap.pad_to_tap_windows(torch.tensor(xp), **pad),
                    jtap.pad_to_tap_windows(jnp.asarray(xp), **pad))
