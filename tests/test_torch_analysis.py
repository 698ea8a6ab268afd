"""The port's analysis modules on the CPU against `repro`'s: the SASiML-lite
model (`core/dataflow_sim.py`), the compile-time PE mapping
(`core/mapping.py`), the padding bookkeeping of `core/ecoflow.py`, the
materialized-zero baselines (`core/naive.py`), the paper tables
(`benchmarks/paper_tables.py`) and the quickstart.

`dataflow_sim`, `mapping` and the `ecoflow` helpers are plain Python or
numpy in the same order on both sides, so they are held equal (`==`).
`naive`'s convs run through XLA on one side and `F.conv2d` on the other:
within 1e-4 (DESIGN.md Sec. 2.3), on the geometries of
`tests/test_mac_accounting.py`.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.core import dataflow_sim as jds
from repro.core import ecoflow as jeco
from repro.core import mapping as jmap
from repro.core import naive as jnaive
from repro_torch.benchmarks import paper_tables as tpt
from repro_torch.core import dataflow_sim as tds
from repro_torch.core import ecoflow as teco
from repro_torch.core import mapping as tmap
from repro_torch.core import naive as tnaive

TOL = 1e-4
OPS = ("forward", "input_grad", "filter_grad", "dilated_forward")
DATAFLOWS = ("rs", "tpu", "ecoflow")
TABLES = ("TABLE5_LAYERS", "OPT_LAYERS", "TABLE7_GAN_LAYERS",
          "DILATED_LAYERS")


def _layers(ds):
    return [l for t in TABLES for l in getattr(ds, t)]


def _port_layer(jl):
    return tds.ConvLayer(**dataclasses.asdict(jl))


# -- dataflow_sim -------------------------------------------------------------

def test_tables_and_constants_equal_repro():
    for t in TABLES:
        assert [dataclasses.asdict(l) for l in getattr(tds, t)] == \
            [dataclasses.asdict(l) for l in getattr(jds, t)], t
    assert tds.END2END_FRACTIONS == jds.END2END_FRACTIONS
    assert tds.GAN_FRACTIONS == jds.GAN_FRACTIONS
    assert dataclasses.asdict(tds.ArrayConfig()) == \
        dataclasses.asdict(jds.ArrayConfig())
    for jl in _layers(jds):
        tl = tds.layer_by_name(jl.name)
        assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
        assert (tl.k_eff, tl.padding) == (jl.k_eff, jl.padding)


@pytest.mark.parametrize("op", OPS)
def test_mac_counts_equal_repro(op):
    for jl in _layers(jds):
        tl = _port_layer(jl)
        assert tds.useful_macs(tl, op) == jds.useful_macs(jl, op)
        assert tds.zero_mac_fraction(tl, op) == jds.zero_mac_fraction(jl, op)
        for df in DATAFLOWS:
            assert tds.scheduled_macs(tl, op, df) == \
                jds.scheduled_macs(jl, op, df), (jl.name, df)


def test_predicated_lane_fraction_equals_repro():
    for jl in _layers(jds):
        assert tds.predicated_lane_fraction(_port_layer(jl)) == \
            jds.predicated_lane_fraction(jl), jl.name


@pytest.mark.parametrize("hw", [(13, 15), (8, 8), (32, 32)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("df", DATAFLOWS)
def test_cycles_time_speedup_and_energy_equal_repro(hw, op, df):
    thw = tds.ArrayConfig(pe_rows=hw[0], pe_cols=hw[1])
    jhw = jds.ArrayConfig(pe_rows=hw[0], pe_cols=hw[1])
    for jl in _layers(jds):
        tl = _port_layer(jl)
        assert tds.cycles(tl, op, df, thw) == jds.cycles(jl, op, df, jhw)
        assert tds.exec_time_s(tl, op, df, thw) == \
            jds.exec_time_s(jl, op, df, jhw)
        for base in DATAFLOWS:
            assert tds.speedup(tl, op, df, base, thw) == \
                jds.speedup(jl, op, df, base, jhw)
        assert tds.energy_breakdown_pj(tl, op, df, thw) == \
            jds.energy_breakdown_pj(jl, op, df, jhw)
        assert tds.energy_pj(tl, op, df, thw) == jds.energy_pj(jl, op, df,
                                                               jhw)


@pytest.mark.parametrize("df", DATAFLOWS)
def test_end_to_end_speedups_equal_repro(df):
    for net in jds.END2END_FRACTIONS:
        assert tds.end_to_end_speedup(net, df) == \
            jds.end_to_end_speedup(net, df)
    for net in jds.GAN_FRACTIONS:
        assert tds.gan_end_to_end_speedup(net, df) == \
            jds.gan_end_to_end_speedup(net, df)
    with pytest.raises(KeyError):
        tds.layer_by_name("no-such-layer")


# -- paper tables -------------------------------------------------------------

@pytest.mark.parametrize("name", [f.__name__ for f in tpt.PAPER_TABLES
                                  + tpt.ABLATIONS])
def test_paper_table_equals_repro(name):
    from benchmarks import paper_tables as jpt
    rows = getattr(tpt, name)()
    assert rows and rows == getattr(jpt, name)()


def test_paper_tables_cli_prints_every_row(capsys):
    rows = tpt.main([])
    out = capsys.readouterr().out.splitlines()
    assert sum(len(f()) for f in tpt.PAPER_TABLES + tpt.ABLATIONS) == \
        len(rows) == len([ln for ln in out if not ln.startswith("#")])
    assert out[1] == ",".join(str(v) for v in rows[0])


# -- mapping ------------------------------------------------------------------

def _schedules(m):
    return {pe: (s.ops, s.multicast, s.owned_labels)
            for pe, s in m.pes.items()}


@pytest.mark.parametrize("O,K,S", [(2, 3, 2), (3, 3, 1), (4, 3, 2),
                                   (2, 5, 2), (3, 4, 3), (4, 2, 4),
                                   (5, 3, 2), (2, 11, 4), (6, 3, 2)])
def test_tconv_mapping_equals_repro(O, K, S):
    assert list(tmap.tconv_products(O, K, S)) == \
        list(jmap.tconv_products(O, K, S))
    tm, jm = tmap.build_tconv_mapping(O, K, S), jmap.build_tconv_mapping(
        O, K, S)
    assert (tm.stride, tm.k, tm.err_n, tm.out_n, tm.pe_rows, tm.pe_cols) == \
        (jm.stride, jm.k, jm.err_n, jm.out_n, jm.pe_rows, jm.pe_cols)
    assert _schedules(tm) == _schedules(jm) and tm.chains == jm.chains
    assert (tm.n_useful_macs, tm.cycle_count()) == \
        (jm.n_useful_macs, jm.cycle_count())
    rng = np.random.default_rng(O * 100 + K * 10 + S)
    err, w = rng.normal(size=(O, O)), rng.normal(size=(K, K))
    assert np.array_equal(tmap.simulate_tconv(tm, err, w),
                          jmap.simulate_tconv(jm, err, w))
    assert np.array_equal(tmap.simulate_tconv_expanded(tm, err, w),
                          jmap.simulate_tconv_expanded(jm, err, w))
    for pr, pc in ((13, 15), (4, 4), (3, 3), (2, 5)):
        assert tmap.group_pe_sets(tm, pr, pc) == jmap.group_pe_sets(jm, pr,
                                                                    pc)
        te = tmap.expand_tconv_mapping(tm, pr, pc)
        je = jmap.expand_tconv_mapping(jm, pr, pc)
        assert (te.pe_rows, te.pe_cols) == (je.pe_rows, je.pe_cols)
        assert _schedules(te) == _schedules(je) and te.chains == je.chains


@pytest.mark.parametrize("N,O,K,S", [(5, 2, 3, 2), (7, 3, 3, 2),
                                     (9, 4, 3, 2), (10, 3, 4, 3)])
def test_dconv_mapping_equals_repro(N, O, K, S):
    tm = tmap.build_dconv_mapping(N, O, K, S)
    jm = jmap.build_dconv_mapping(N, O, K, S)
    assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
    assert (tm.n_useful_macs, tm.cycle_count()) == \
        (jm.n_useful_macs, jm.cycle_count())
    rng = np.random.default_rng(N + O + K + S)
    x, err = rng.normal(size=(N, N)), rng.normal(size=(O, O))
    assert np.array_equal(tmap.simulate_dconv(tm, x, err),
                          jmap.simulate_dconv(jm, x, err))


# -- ecoflow helpers ----------------------------------------------------------

@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (16, 3, 2), (8, 5, 4),
                                   (12, 11, 4), (16, 3, 8), (27, 5, 2),
                                   (29, 3, 2), (1, 1, 1)])
def test_ecoflow_helpers_equal_repro(n, k, s):
    assert teco.tconv_inner_padding(n, s) == jeco.tconv_inner_padding(n, s)
    assert teco.tconv_outer_padding(n, k, s) == \
        jeco.tconv_outer_padding(n, k, s)
    assert teco.dconv_inner_padding(n, s) == jeco.dconv_inner_padding(n, s)
    assert teco.tconv_zero_mac_fraction(n, k, s) == \
        jeco.tconv_zero_mac_fraction(n, k, s)
    assert teco.dconv_zero_mac_fraction(n, s) == \
        jeco.dconv_zero_mac_fraction(n, s)
    for p in range(k):
        assert teco.transposed_conv_input_size(n, k, s, p) == \
            jeco.transposed_conv_input_size(n, k, s, p)


# -- naive --------------------------------------------------------------------

def _np(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("s", [1, 2, 3, (2, 3)])
def test_zero_insertion_equals_repro(s):
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    w = rng.standard_normal((3, 2, 3, 4)).astype(np.float32)
    assert np.array_equal(tnaive.dilate_insert_zeros(torch.tensor(x),
                                                     s).numpy(),
                          _np(jnaive.dilate_insert_zeros(jnp.asarray(x), s)))
    assert np.array_equal(
        tnaive.dilate_filter_insert_zeros(torch.tensor(w), s).numpy(),
        _np(jnaive.dilate_filter_insert_zeros(jnp.asarray(w), s)))


@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (16, 3, 2), (8, 5, 4),
                                   (12, 11, 4), (16, 3, 8), (27, 5, 2)])
@pytest.mark.parametrize("p", [0, 1])
def test_transposed_conv_naive_matches_repro(n, k, s, p):
    """`n` is the error map's size, as in `tconv_zero_mac_fraction`."""
    rng = np.random.default_rng(21)
    dy = rng.standard_normal((2, n, n, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    n_full = s * (n - 1) + k - 2 * p
    for n_out in (None, (n_full, n_full), (n_full + s - 1, n_full)):
        got = tnaive.transposed_conv_naive(torch.tensor(dy), torch.tensor(w),
                                           stride=s, padding=p, n_out=n_out)
        want = jnaive.transposed_conv_naive(jnp.asarray(dy), jnp.asarray(w),
                                            stride=s, padding=p, n_out=n_out)
        assert tuple(got.shape) == want.shape
        assert_allclose(got, want, rtol=TOL, atol=TOL)
        # ... and it is the transposed conv the zero-free path computes.
        if n_out is not None:
            assert_allclose(got, teco.transposed_conv_zero_free(
                torch.tensor(dy), torch.tensor(w), stride=s, padding=p,
                n_out=n_out), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,s", [(8, 2), (16, 2), (8, 4), (27, 2), (7, 8)])
@pytest.mark.parametrize("k,p", [(3, 1), (4, 0)])
def test_filter_grad_naive_matches_repro(n, s, k, p):
    """`n` is the error map's size; x is the exact-fit input."""
    rng = np.random.default_rng(22)
    N = s * (n - 1) + k - 2 * p
    x = rng.standard_normal((2, N, N, 3)).astype(np.float32)
    dy = rng.standard_normal((2, n, n, 4)).astype(np.float32)
    got = tnaive.dilated_conv_filter_grad_naive(
        torch.tensor(x), torch.tensor(dy), stride=s, padding=p, k=(k, k))
    want = jnaive.dilated_conv_filter_grad_naive(
        jnp.asarray(x), jnp.asarray(dy), stride=s, padding=p, k=(k, k))
    assert tuple(got.shape) == want.shape == (k, k, 3, 4)
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_allclose(got, teco.dilated_conv_filter_grad_zero_free(
        torch.tensor(x), torch.tensor(dy), stride=s, padding=p, k=(k, k)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,d", [(3, 2), (3, 4), (5, 2), (2, 3), (1, 4)])
@pytest.mark.parametrize("s,p", [(1, 0), (2, 1)])
def test_dilated_forward_naive_matches_repro(k, d, s, p):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 17, 17, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    got = tnaive.dilated_forward_naive(torch.tensor(x), torch.tensor(w),
                                       stride=s, padding=p, dilation=d)
    want = jnaive.dilated_forward_naive(jnp.asarray(x), jnp.asarray(w),
                                        stride=s, padding=p, dilation=d)
    assert tuple(got.shape) == want.shape
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tnaive.dilated_forward_zero_mac_fraction(k, d) == \
        jnaive.dilated_forward_zero_mac_fraction(k, d)


# -- the quickstart -----------------------------------------------------------

def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart as qs
    res = qs.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for section in range(1, 6):
        assert f"== {section}." in out
    assert res["device"] == "cpu" and res["mapping_ok"]
    assert res["zero_mac_fraction"] == {
        "input_grad": jeco.tconv_zero_mac_fraction(qs.O, qs.K, qs.S),
        "filter_grad": jeco.dconv_zero_mac_fraction(qs.O, qs.S)}
    g = res["grads"]
    for name in ("dx", "dw"):
        for other in ("_ref", "_naive"):
            assert_allclose(g[name], g[name + other], rtol=TOL, atol=TOL,
                            err_msg=name + other)
    assert set(res["ms"]) == {"input_grad", "filter_grad"}
    assert all(set(t) == set(qs.ARMS) and min(t.values()) > 0
               for t in res["ms"].values())
    assert res["drop_in"]["finite"]
    assert tuple(res["drop_in"]["gw"].shape) == (qs.K, qs.K, qs.Ci, qs.Co)


def test_quickstart_gradients_match_repros_vjp():
    """Section 2's inputs and gradients against `jax.vjp` of `repro`'s
    plain conv on the same numpy draw (`examples/quickstart.py:24-27`)."""
    import jax
    from repro_torch.examples import quickstart as qs
    rng = np.random.default_rng(0)
    x = rng.normal(size=(qs.B, qs.N, qs.N, qs.Ci))
    w = rng.normal(size=(qs.K, qs.K, qs.Ci, qs.Co))
    dy = rng.normal(size=(qs.B, qs.O, qs.O, qs.Co))
    jx, jw, jdy = (jnp.asarray(a, jnp.float32) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: jeco.direct_conv(a, b, qs.S, qs.P), jx, jw)
    dx_ref, dw_ref = vjp(jdy)
    res = qs.main(["--device", "cpu"])
    assert_allclose(res["grads"]["dx"], dx_ref, rtol=TOL, atol=TOL)
    assert_allclose(res["grads"]["dw"], dw_ref, rtol=TOL, atol=TOL)
