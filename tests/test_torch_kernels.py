"""The port's kernel modules on the CPU against `repro`.

On CPU tensors every wrapper of `repro_torch.kernels.ops` runs its
kernel's plain PyTorch version.  Those are held against `repro`'s own
kernels in interpret mode at tiny geometries, and against `repro`'s
`xla_zero_free` backend on the stride x dilation x ragged x B>1 grid,
bias fills and non-exact n_out included.  Inputs come from numpy seeds;
fp32 at rtol = atol = 1e-4 (DESIGN.md Sec. 2.3).  The kernels themselves
are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import EP_KW, FWD_GRID, TCONV_GRID, tconv_case
from conftest import assert_allclose
from repro.core import spec as jspec
from repro.kernels import ops as jops
from repro_torch.core import spec as tspec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tiling as ttiling
from repro_torch.kernels.dconv_backward import plan as backward_plan
from repro_torch.kernels.implicit_gemm import plan as ig_plan


def _eps(kw):
    if kw is None:
        return None, None
    return tspec.Epilogue(**kw), jspec.Epilogue(**kw)

@functools.lru_cache(maxsize=None)
def _tconv_xla_zero_free(i):
    """`repro`'s xla_zero_free transposed conv of TCONV_GRID[i], under
    each epilogue of EP_KW; computed once for both strategies."""
    spec, n_out, dy, w, bias = tconv_case(TCONV_GRID[i], 0)
    js = jspec.ConvSpec.make(stride=spec.stride, padding=spec.padding,
                             filter_shape=spec.filter_shape,
                             dilation=spec.dilation)
    base = jspec.resolve_backend("xla_zero_free")
    plain = base.input_grad(jnp.asarray(dy), jnp.asarray(w), js, n_out)
    out = []
    for kw in EP_KW:
        je = None if kw is None else jspec.Epilogue(**kw)
        out.append(np.asarray(plain if je is None else je.apply(
            plain, jnp.asarray(bias) if je.bias else None)))
    return out


@pytest.mark.parametrize("strategy", ["phase", "implicit_gemm"])
@pytest.mark.parametrize("i", range(len(TCONV_GRID)))
def test_tconv_plain_matches_xla_zero_free(i, strategy):
    spec, n_out, dy, w, bias = tconv_case(TCONV_GRID[i], 0)
    for kw, want in zip(EP_KW, _tconv_xla_zero_free(i)):
        te = None if kw is None else tspec.Epilogue(**kw)
        b = bias if kw is not None and te.bias else None
        got = tops.tconv_phase(
            torch.tensor(dy), torch.tensor(w), stride=spec.stride,
            padding=spec.padding, n_out=n_out, dilation=spec.dilation,
            bias=None if b is None else torch.tensor(b), epilogue=te,
            strategy=strategy)
        assert_allclose(got, want, err_msg=f"{TCONV_GRID[i]} {kw}")


@pytest.mark.parametrize("geom", FWD_GRID)
def test_dconv_forward_plain_matches_xla_zero_free(geom):
    s, d, k, p = geom
    spec = tspec.ConvSpec.make(stride=s, padding=p, filter_shape=k,
                               dilation=d)
    js = jspec.ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 9, 3)).astype(np.float32)
    w = rng.standard_normal(spec.filter_shape + (3, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    base = jspec.resolve_backend("xla_zero_free")
    for kw in EP_KW:
        te, je = _eps(kw)
        b = bias if kw is not None and te.bias else None
        got = tops.dconv_forward(torch.tensor(x), torch.tensor(w), stride=s,
                                 padding=p, dilation=d,
                                 bias=None if b is None else torch.tensor(b),
                                 epilogue=te)
        want = base.forward(jnp.asarray(x), jnp.asarray(w), js) \
            if je is None else base.forward_ep(
                jnp.asarray(x), jnp.asarray(w),
                None if b is None else jnp.asarray(b), js, je)
        assert_allclose(got, want, err_msg=f"{geom} {kw}")


@pytest.mark.parametrize("strategy", ["phase", "implicit_gemm"])
def test_tconv_plain_matches_pallas_interpret(strategy):
    """The plain versions against `repro`'s Pallas kernels themselves
    (interpret mode on the CPU), one tiny generator-like geometry."""
    rng = np.random.default_rng(3)
    dy = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    te, je = _eps(dict(activation="relu", bias=True))
    kw = dict(stride=(2, 2), padding=(1, 1), n_out=(7, 7), dilation=(1, 1),
              strategy=strategy)
    want = jops.tconv_phase(jnp.asarray(dy), jnp.asarray(w),
                            bias=jnp.asarray(bias), epilogue=je, **kw)
    got = tops.tconv_phase(torch.tensor(dy), torch.tensor(w),
                           bias=torch.tensor(bias), epilogue=te, **kw)
    assert_allclose(got, want)


def test_dconv_forward_plain_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    te, je = _eps(dict(activation="relu", bias=True))
    kw = dict(stride=(1, 1), padding=(2, 2), dilation=(2, 2))
    want = jops.dconv_forward(jnp.asarray(x), jnp.asarray(w),
                              bias=jnp.asarray(bias), epilogue=je, **kw)
    got = tops.dconv_forward(torch.tensor(x), torch.tensor(w),
                             bias=torch.tensor(bias), epilogue=te, **kw)
    assert_allclose(got, want)


GEN_LAYERS = [("t1", 4, 8, 64, 128), ("t2", 8, 16, 32, 64),
              ("t3", 16, 32, 3, 32)]


@pytest.mark.parametrize("batch", [2, 4, 64])
@pytest.mark.parametrize("layer", GEN_LAYERS, ids=[g[0] for g in GEN_LAYERS])
def test_plan_strategy_picks_the_hopper_race_winner(layer, batch):
    """The analytical Hopper race sends every generator layer to the
    implicit GEMM (B.5), which the card measured faster at all six points
    (PERF.md section 6), at the CPU tests' batch 2 too: `repro`'s TPU
    cost model, which sends t1 and t2 to the phase kernel, does not apply
    to the card (ROADMAP C).  The plan is `implicit_gemm.plan`'s."""
    _, n_in, n_out, cin, cout = layer
    spec = tspec.ConvSpec.make(stride=2, padding=1, filter_shape=4)
    kw = dict(x_shape=(batch, n_out, n_out, cin),
              dy_shape=(batch, n_in, n_in, cout))
    ep = tspec.Epilogue(activation="tanh" if cin == 3 else "relu")
    costs = ttiling.race_costs_us(spec, ep=ep, **kw)
    assert costs["implicit_gemm"] < costs["phase"]
    assert ttiling.plan_strategy("input_grad", spec, epilogue=ep, **kw) == (
        "implicit_gemm", ig_plan(spec, batch, (n_out, n_out), (n_in, n_in),
                                 cin, cout))


def test_plan_strategy_pins_and_refusals():
    spec = tspec.ConvSpec.make(stride=2, padding=1, filter_shape=4)
    kw = dict(x_shape=(4, 8, 8, 64), dy_shape=(4, 4, 4, 128))
    args = (spec, 4, (8, 8), (4, 4), 64, 128)
    assert ttiling.plan_strategy("input_grad", spec, strategy="implicit_gemm",
                                 **kw) == ("implicit_gemm", ig_plan(*args))
    assert ttiling.plan_strategy("input_grad", spec, strategy="phase",
                                 **kw) == ("phase", backward_plan(
                                     "tconv_phase", *args, n_out=(8, 8)))
    assert ttiling.plan_strategy("input_grad", spec, strategy="auto",
                                 **kw)[0] == "implicit_gemm"
    # only the standalone input gradient has an implicit-GEMM kernel
    assert ttiling.plan_strategy("forward", spec, strategy="implicit_gemm",
                                 **kw)[0] == "phase"
    with pytest.raises(ValueError, match="unknown strategy"):
        ttiling.plan_strategy("input_grad", spec, strategy="fastest", **kw)


def test_wrappers_refuse_other_dtypes_and_devices():
    x = torch.zeros((1, 6, 6, 3), dtype=torch.float64)
    w = torch.zeros((3, 3, 3, 4), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tops.dconv_forward(x, w, stride=1, padding=1, dilation=1)
    # bf16 is taken, on the CPU through the plain version, and gives bf16.
    dx = tops.tconv_phase(torch.ones((1, 3, 3, 4), dtype=torch.bfloat16),
                          torch.ones((4, 4, 3, 4), dtype=torch.bfloat16),
                          stride=2, padding=1, n_out=(6, 6))
    assert dx.dtype == torch.bfloat16 and dx.shape == (1, 6, 6, 3)
    assert bool((dx > 0).all())
    # ... but not beside an fp32 operand: both dtypes are named.
    with pytest.raises(TypeError, match="bfloat16 and torch.float32"):
        tops.tconv_phase(torch.zeros((1, 3, 3, 4), dtype=torch.bfloat16),
                         torch.zeros((4, 4, 3, 4)), stride=2, padding=1,
                         n_out=(6, 6))
    with pytest.raises(TypeError, match="float64"):
        tops.conv_backward(torch.zeros((1, 6, 6, 3)),
                           torch.zeros((1, 6, 6, 4)), w, stride=1,
                           padding=1, n_out=(6, 6))
    with pytest.raises(ValueError, match="bias"):
        tops.dconv_forward(x.float(), w.float(), stride=1, padding=1,
                           dilation=1, epilogue=tspec.Epilogue(bias=True))
    with pytest.raises(ValueError, match="too small"):
        tops.dconv_forward(torch.zeros((1, 2, 2, 3)),
                           torch.zeros((3, 3, 3, 4)), stride=1, padding=0,
                           dilation=2)


def test_plain_path_counts_no_launch():
    rng = np.random.default_rng(9)
    dy = torch.tensor(rng.standard_normal((1, 3, 3, 4)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((4, 4, 8, 4)).astype(np.float32))
    tops.reset_launches()
    pinned = tops.tconv_implicit_gemm(dy, w, stride=2, padding=1,
                                      n_out=(6, 6))
    assert torch.equal(pinned, tops.tconv_phase(
        dy, w, stride=2, padding=1, n_out=(6, 6), strategy="implicit_gemm"))
    assert_allclose(pinned, tops.tconv_phase(dy, w, stride=2, padding=1,
                                             n_out=(6, 6)))   # the race's
    x, w3 = torch.zeros((1, 6, 6, 3)), torch.zeros((3, 3, 3, 4))
    y = tops.dconv_forward(x, w3, stride=1, padding=1, dilation=1)
    tops.conv_backward(x, y, w3, stride=1, padding=1, n_out=(6, 6))
    tops.tconv_backward(x, y, w3, stride=1, padding=1)
    tops.dconv_filter_grad(x, y, stride=1, padding=1, k=3)
    assert tops.LAUNCHES == {"dconv_forward": 0, "tconv_phase": 0,
                             "tconv_implicit_gemm": 0, "conv_backward": 0,
                             "tconv_backward": 0, "dconv_filter_grad": 0,
                             "flash_attention": 0,
                             "flash_attention_backward": 0}
    q = torch.zeros((1, 70, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 70, 2, 64), dtype=torch.bfloat16)
    out, lse = tops._flash_forward(q, kv, kv, True, 0, 128, return_lse=True)
    tops.flash_attention_backward(q, kv, kv, out, q, lse, causal=True,
                                  q_offset=0)
    assert tops.LAUNCHES["flash_attention_backward"] == 0
    assert tops.FLASH_FORMS == {"tile": 0, "wgmma": 0, "split": 0}
    assert tops.FLASH_BWD_FORMS == {"simt": 0, "wgmma": 0}


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int",
            "float": "c_float", "int64_t": ctypes.c_int64.__name__}


@pytest.mark.parametrize("module,source,symbol,argtypes", [
    (module, source, f"{base}_{suffix}", argtypes)
    for module, source, base, argtypes in (
        ("dconv_forward", "dconv_forward", "dconv_forward", "_ARGTYPES"),
        ("tconv_phase", "tconv_phase", "tconv_phase", "_ARGTYPES"),
        ("implicit_gemm", "implicit_gemm", "tconv_implicit_gemm",
         "_ARGTYPES"),
        ("dconv_backward", "conv_backward", "conv_backward",
         "_BWD_ARGTYPES"),
        ("dconv_backward", "tconv_backward", "tconv_backward",
         "_CT_ARGTYPES"),
        ("dconv_filtergrad", "dconv_filtergrad", "dconv_filter_grad",
         "_ARGTYPES"))
    for suffix in ("f32", "bf16")] + [
    ("attention", "flash_attention", "flash_attention_f32", "_ARGTYPES"),
    ("attention", "flash_attention", "flash_attention_bf16", "_ARGTYPES"),
    ("attention", "flash_attention_bwd", "flash_attention_bwd_f32",
     "_BWD_ARGTYPES"),
    ("attention", "flash_attention_bwd", "flash_attention_bwd_bf16",
     "_BWD_ARGTYPES"),
])
def test_c_entries_take_the_wrappers_argtypes(module, source, symbol,
                                              argtypes):
    """ctypes passes what `argtypes` says: each C entry's parameter list
    (no compiler here to check it) must match it type for type.  A list
    written as one macro (a conv kernel's `_f32` and `_bf16` entries
    share theirs) is read from its #define."""
    import importlib
    import re

    from repro_torch.kernels import build
    text = (build.CSRC / f"{source}.cu").read_text()
    sig = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                    re.S).group(1)
    if re.fullmatch(r"\s*[A-Z_]+\s*", sig):
        sig = re.search(r"#define " + sig.strip() + r"\s*\\\n(.*?[^\\])\n",
                        text, re.S).group(1).replace("\\\n", " ")
        sig = sig.replace("*", "* ").replace(" * ", "* ")
    params = [" ".join(p.split()[:-1]) for p in sig.replace("\n", " ")
              .split(",")]
    want = [_C_TYPES[p] for p in params]
    got = [t.__name__ for t in getattr(importlib.import_module(
        f"repro_torch.kernels.{module}"), argtypes)]
    assert got == want


@pytest.mark.parametrize("source,enum,forms", [
    ("flash_attention", "Form", "FORMS"),
    ("flash_attention_bwd", "BwdForm", "BWD_FORMS"),
])
def test_form_codes_match_the_c_enums(source, enum, forms):
    """The wrappers pass a form as its index in FORMS / BWD_FORMS: each C
    enum must list the same forms in the same order."""
    import re

    from repro_torch.kernels import attention, build
    text = (build.CSRC / f"{source}.cu").read_text()
    body = re.search(r"enum " + enum + r" \{(.*?)\};", text, re.S).group(1)
    codes = {name.split("_", 1)[1].lower(): int(val) for name, val in
             re.findall(r"(\w+) = (\d+)", body)}
    assert codes == {f: i for i, f in enumerate(getattr(attention, forms))}
