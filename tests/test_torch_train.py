"""The port's training slice on the CPU against `repro`: `ConvDataset`,
`tree_all_finite`, the CNN step (`sgd_step`) and the GAN steps
(`gen_sgd_step`, `gan_sgd_step`) with their guarded forms, and the
per-step launch table `chip_smoke.py` holds the card to.

The steps take `repro`'s own init (converted with
`convert.params_from_numpy`) and the same `ConvDataset` batch, on each of
the port's three backends, against `repro`'s steps on its `reference`
backend, at small widths, with and without the fused epilogues.
Tolerance: loss and every new parameter within rtol = atol = 1e-4 (fp32
on both sides; only the order of the sums differs).
"""
from __future__ import annotations

import collections
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose, count_pallas_calls
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.models import gan as jgan
from repro.models import layers as jlayers
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.models import cnn as tcnn
from repro_torch.models import gan as tgan
from repro_torch.models import layers as tlayers

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
BACKENDS = ["cuda", "torch_zero_free", "reference"]
Z_DIM, BASE, BATCH = 8, 16, 2
CNN_WIDTHS, IMAGE = (4, 8, 16), 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """Leaves of a port tree in `jax.tree_util`'s order (sorted keys)."""
    return jax.tree_util.tree_leaves(
        tlayers.tree_map(lambda t: t.detach().numpy(), tree))


def _assert_flag(flag, device):
    """The guard's flag: a 0-d bool tensor on the step's device (no host
    read inside the step), as `repro`'s is a jax.Array in the jit."""
    assert isinstance(flag, torch.Tensor)
    assert flag.dtype == torch.bool and flag.dim() == 0
    assert flag.device == device


def _assert_tree_close(got, want, err_msg=""):
    got_leaves = _leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (a, b) in enumerate(zip(got_leaves, want_leaves)):
        assert tuple(a.shape) == tuple(b.shape)
        assert_allclose(a, b, rtol=TOL, atol=TOL,
                        err_msg=f"{err_msg} leaf {i}")


@functools.lru_cache(maxsize=None)
def _gan_state():
    return _np(jgan.gan_init(jax.random.PRNGKey(0), z_dim=Z_DIM, base=BASE))


@functools.lru_cache(maxsize=None)
def _cnn_params():
    return _np(jcnn.simple_cnn_init(jax.random.PRNGKey(1),
                                    widths=CNN_WIDTHS))


def _gan_batch():
    return jpipe.ConvDataset(kind="gan", batch=BATCH, z_dim=Z_DIM,
                             seed=3).batch_at(5)


def _cnn_batch():
    return jpipe.ConvDataset(kind="cnn", batch=BATCH, image=IMAGE,
                             seed=4).batch_at(2)


# -- data and tree helpers --------------------------------------------------

@pytest.mark.parametrize("kind", ["cnn", "gan", "gan_gen"])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_conv_dataset_is_bit_identical_to_repro(kind, step):
    kw = dict(kind=kind, batch=3, image=10, channels=3, n_classes=7,
              z_dim=5, seed=11)
    got = tpipe.ConvDataset(**kw).batch_at(step)
    want = jpipe.ConvDataset(**kw).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = tpipe.ConvDataset(**kw).iterate(step)
    np.testing.assert_array_equal(next(it)["z" if kind != "cnn" else "x"],
                                  want["z" if kind != "cnn" else "x"])
    with pytest.raises(ValueError):
        tpipe.ConvDataset(kind="lm", batch=1)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_tree_all_finite_matches_repro(bad):
    leaves = {"a": np.ones((2, 3), np.float32),
              "b": [np.arange(4, dtype=np.int32),
                    np.zeros(2, np.float32)]}
    if bad is not None:
        leaves["b"][1][1] = bad
    want = bool(jlayers.tree_all_finite(leaves, np.float32(1.0)))
    got = tlayers.tree_all_finite(params_from_numpy(leaves, "cpu"),
                                  torch.tensor(1.0))
    _assert_flag(got, torch.device("cpu"))
    assert bool(got) is want


def test_tree_all_finite_without_a_floating_leaf_is_true():
    got = tlayers.tree_all_finite({"labels": torch.arange(3)}, [])
    _assert_flag(got, torch.device("cpu"))
    assert bool(got) is True


def test_params_from_numpy_carries_the_training_trees():
    for tree in (_gan_state(), _cnn_params()):
        got = params_from_numpy(tree, "cpu")
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(
                tlayers.tree_map(lambda t: t.numpy(), got))
        _assert_tree_close(got, tree)


# -- the steps against repro's reference backend -----------------------------

@functools.lru_cache(maxsize=None)
def _repro_cnn_step(fuse, guarded):
    b = _cnn_batch()
    step = jcnn.guarded_sgd_step if guarded else jcnn.sgd_step
    return step(_cnn_params(), jnp.asarray(b["x"]), jnp.asarray(b["labels"]),
                backend="reference", fuse_epilogue=fuse)


@functools.lru_cache(maxsize=None)
def _repro_gen_step(fuse, guarded):
    st = _gan_state()
    step = jgan.guarded_gen_sgd_step if guarded else jgan.gen_sgd_step
    return step(st["g"], st["d"], jnp.asarray(_gan_batch()["z"]),
                backend="reference", fuse_epilogue=fuse)


@functools.lru_cache(maxsize=None)
def _repro_gan_step(fuse, guarded):
    b = _gan_batch()
    step = jgan.guarded_gan_sgd_step if guarded else jgan.gan_sgd_step
    return step(_gan_state(), jnp.asarray(b["z"]), jnp.asarray(b["real"]),
                backend="reference", fuse_epilogue=fuse)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sgd_step_matches_repro(backend, fuse):
    b = _cnn_batch()
    got, loss = tcnn.sgd_step(params_from_numpy(_cnn_params(), "cpu"),
                              torch.tensor(b["x"]), torch.tensor(b["labels"]),
                              backend=backend, fuse_epilogue=fuse)
    want, want_loss = _repro_cnn_step(fuse, False)
    assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gen_sgd_step_matches_repro(backend, fuse):
    st = params_from_numpy(_gan_state(), "cpu")
    got, loss = tgan.gen_sgd_step(st["g"], st["d"],
                                  torch.tensor(_gan_batch()["z"]),
                                  backend=backend, fuse_epilogue=fuse)
    want, want_loss = _repro_gen_step(fuse, False)
    assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gan_sgd_step_matches_repro(backend, fuse):
    b = _gan_batch()
    got, g_loss, d_loss = tgan.gan_sgd_step(
        params_from_numpy(_gan_state(), "cpu"), torch.tensor(b["z"]),
        torch.tensor(b["real"]), backend=backend, fuse_epilogue=fuse)
    want, want_g, want_d = _repro_gan_step(fuse, False)
    assert_allclose(g_loss, want_g, rtol=TOL, atol=TOL)
    assert_allclose(d_loss, want_d, rtol=TOL, atol=TOL)
    _assert_tree_close(got, want)


def test_guarded_steps_match_repro():
    b = _cnn_batch()
    new, loss, ok = tcnn.guarded_sgd_step(
        params_from_numpy(_cnn_params(), "cpu"), torch.tensor(b["x"]),
        torch.tensor(b["labels"]), backend="cuda")
    want, want_loss, want_ok = _repro_cnn_step(True, True)
    _assert_flag(ok, loss.device)
    assert bool(ok) is bool(want_ok) is True
    assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
    _assert_tree_close(new, want)

    st = params_from_numpy(_gan_state(), "cpu")
    z = torch.tensor(_gan_batch()["z"])
    new, loss, ok = tgan.guarded_gen_sgd_step(st["g"], st["d"], z,
                                              backend="cuda")
    want, want_loss, want_ok = _repro_gen_step(True, True)
    _assert_flag(ok, loss.device)
    assert bool(ok) is bool(want_ok) is True
    _assert_tree_close(new, want)

    real = torch.tensor(_gan_batch()["real"])
    new, g_loss, d_loss, ok = tgan.guarded_gan_sgd_step(st, z, real,
                                                        backend="cuda")
    want, want_g, want_d, want_ok = _repro_gan_step(True, True)
    _assert_flag(ok, g_loss.device)
    assert bool(ok) is bool(want_ok) is True
    assert_allclose(d_loss, want_d, rtol=TOL, atol=TOL)
    _assert_tree_close(new, want)


def test_guarded_step_flags_a_non_finite_update():
    """A NaN in the params reaches the updated params: the flag drops."""
    p = params_from_numpy(_cnn_params(), "cpu")
    p["head"][0, 0] = float("nan")
    b = _cnn_batch()
    _, _, ok = tcnn.guarded_sgd_step(p, torch.tensor(b["x"]),
                                     torch.tensor(b["labels"]),
                                     backend="cuda")
    _assert_flag(ok, torch.device("cpu"))
    assert bool(ok) is False


def test_steps_do_not_touch_the_callers_params():
    p = params_from_numpy(_cnn_params(), "cpu")
    before = [t.clone() for t in tlayers.tree_leaves(p)]
    b = _cnn_batch()
    new, _ = tcnn.sgd_step(p, torch.tensor(b["x"]), torch.tensor(b["labels"]),
                           backend="cuda")
    for t, t0 in zip(tlayers.tree_leaves(p), before):
        assert torch.equal(t, t0) and t.grad is None and not t.requires_grad
    assert all(not t.requires_grad for t in tlayers.tree_leaves(new))


def test_inits_give_repro_shapes():
    gen = torch.Generator().manual_seed(0)
    for got, want in (
            (tgan.gan_init(gen, z_dim=Z_DIM, base=BASE, device="cpu"),
             _gan_state()),
            (tcnn.simple_cnn_init(gen, widths=CNN_WIDTHS, device="cpu"),
             _cnn_params())):
        assert [tuple(t.shape) for t in _leaves(got)] == \
            [tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]


# -- the launch table of chip_smoke.py ----------------------------------------

_PALLAS = {"tconv_fused_pallas": "tconv_phase",
           "tconv_implicit_gemm_pallas": "tconv_implicit_gemm",
           "dconv_forward_pallas": "dconv_forward",
           "conv_backward_pallas": "conv_backward",
           "tconv_backward_pallas": "tconv_backward",
           "dconv_filter_grad_pallas": "dconv_filter_grad"}
_PLAIN = {"tconv_fused_plain": "tconv_phase",
          "tconv_implicit_gemm_plain": "tconv_implicit_gemm",
          "dconv_forward_plain": "dconv_forward",
          "conv_backward_plain": "conv_backward",
          "tconv_backward_plain": "tconv_backward",
          "dconv_filter_grad_plain": "dconv_filter_grad"}


def _step_table():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STEP_LAUNCHES


def _counting(monkeypatch, module, names):
    counts = collections.Counter()
    for attr, kernel in names.items():
        def wrap(*a, _f=getattr(module, attr), _k=kernel, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(module, attr, wrap)
    return counts


def _merge_tconv(counts):
    out = dict(counts)
    out["tconv"] = out.pop("tconv_phase", 0) + \
        out.pop("tconv_implicit_gemm", 0)
    return out


def _repro_steps():
    st = jgan.gan_init(jax.random.PRNGKey(0), z_dim=Z_DIM, base=BASE)
    z, real = jnp.zeros((BATCH, Z_DIM)), jnp.zeros((BATCH, 32, 32, 3))
    p = jcnn.simple_cnn_init(jax.random.PRNGKey(1), widths=CNN_WIDTHS)
    x = jnp.zeros((BATCH, IMAGE, IMAGE, 3))
    labels = jnp.zeros((BATCH,), jnp.int32)
    return {
        "gan_sgd_step": (lambda s, z_, r: jgan.gan_sgd_step(
            s, z_, r, backend="pallas"), (st, z, real)),
        "gen_sgd_step": (lambda g, d, z_: jgan.gen_sgd_step(
            g, d, z_, backend="pallas"), (st["g"], st["d"], z)),
        "sgd_step": (lambda p_, x_, l_: jcnn.sgd_step(
            p_, x_, l_, backend="pallas"), (p, x, labels)),
    }


@pytest.mark.parametrize("step", ["gan_sgd_step", "gen_sgd_step",
                                  "sgd_step"])
def test_step_launch_table_matches_repro_pallas_calls(step, monkeypatch):
    """chip_smoke.py's per-step table sums to `count_pallas_calls` of
    `repro`'s step on `pallas` (27 / 12 / 6), kernel by kernel.  The
    transposed convs are compared as one total: `repro` in interpret mode
    races phase against implicit GEMM with its interpret-mode cost model,
    while the port takes `repro`'s compiled-mode choice
    (test_torch_kernels.py pins that rule)."""
    table = _step_table()[step]
    fn, args = _repro_steps()[step]
    counts = _counting(monkeypatch, jops, _PALLAS)
    assert count_pallas_calls(fn, *args) == sum(table.values()) == \
        {"gan_sgd_step": 27, "gen_sgd_step": 12, "sgd_step": 6}[step]
    assert _merge_tconv(counts) == _merge_tconv(table)


@pytest.mark.parametrize("step", ["gan_sgd_step", "gen_sgd_step",
                                  "sgd_step"])
def test_port_step_calls_each_kernel_as_the_table_says(step, monkeypatch):
    """On CPU tensors each wrapper runs its kernel's plain version where
    the card launches the kernel: at the models' published widths (batch
    2) the port's steps reach each of them exactly as often as
    chip_smoke.py's table says, the transposed-conv split included."""
    counts = _counting(monkeypatch, tops, _PLAIN)
    gen = torch.Generator().manual_seed(0)
    ds = tpipe.ConvDataset(kind="gan", batch=2, z_dim=64, seed=0).batch_at(0)
    z, real = torch.tensor(ds["z"]), torch.tensor(ds["real"])
    if step == "sgd_step":
        p = tcnn.simple_cnn_init(gen, device="cpu")
        b = tpipe.ConvDataset(kind="cnn", batch=2, image=32).batch_at(0)
        tcnn.sgd_step(p, torch.tensor(b["x"]), torch.tensor(b["labels"]),
                      backend="cuda")
    else:
        st = tgan.gan_init(gen, z_dim=64, base=64, device="cpu")
        if step == "gen_sgd_step":
            tgan.gen_sgd_step(st["g"], st["d"], z, backend="cuda")
        else:
            tgan.gan_sgd_step(st, z, real, backend="cuda")
    assert dict(counts) == _step_table()[step]


# -- phase 8's launch table (VISION_LAUNCHES) ---------------------------------

def _vision_cases():
    """(repro's loss-and-grads callable, its args, the port's CPU call) of
    each VISION_LAUNCHES entry, at small widths (the counts do not depend
    on them)."""
    from repro.models import vision as jvision
    from repro.optim import optimizer as jopt
    from repro_torch.examples import segment_atrous as tex
    from repro_torch.models import vision as tvision
    from repro_torch.optim import optimizer as topt

    head = jvision.atrous_head_init(jax.random.PRNGKey(0), in_ch=3, width=4,
                                    n_classes=4)
    x = jnp.zeros((2, 12, 12, 3))
    y = jnp.zeros((2, 12, 12), jnp.int32)
    patch = jvision.patchify_init(jax.random.PRNGKey(1), d_model=8)
    img = jnp.zeros((2, 28, 28, 3))
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, weight_decay=0.01)

    def j_loss(p):
        return jax.value_and_grad(lambda q: jvision.atrous_seg_loss(
            q, x, y, backend="pallas"))(p)

    def j_step(p, opt):
        _, g = j_loss(p)
        p, opt, _ = jopt.adamw_update(g, opt, p, cfg)
        return jvision.atrous_head_apply(p, x, backend="pallas")

    def j_patch(p):
        return jax.grad(lambda q: jnp.sum(jvision.patchify_apply(
            q, img, backend="pallas") ** 2))(p)

    th = params_from_numpy(jax.tree.map(np.asarray, head), "cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, patch), "cpu")
    tx, ty = torch.zeros((2, 12, 12, 3)), torch.zeros((2, 12, 12),
                                                      dtype=torch.int32)
    tcfg = topt.AdamWConfig(lr=3e-3, warmup_steps=10, weight_decay=0.01)
    return {
        "atrous_seg_loss": (j_loss, (head,), lambda: tlayers.sgd_grads(
            lambda q: tvision.atrous_seg_loss(q, tx, ty, backend="cuda"),
            th)),
        "segment_atrous_step": (
            j_step, (head, jopt.adamw_init(head, cfg)),
            lambda: tex.make_step(tcfg)(th, topt.adamw_init(th, tcfg), tx,
                                        ty)),
        "patchify": (j_patch, (patch,), lambda: tlayers.sgd_grads(
            lambda q: torch.sum(tvision.patchify_apply(
                q, torch.zeros((2, 28, 28, 3)), backend="cuda") ** 2), tp)),
    }


def _smoke_table(name):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


@pytest.mark.parametrize("step", ["atrous_seg_loss", "segment_atrous_step",
                                  "patchify"])
def test_vision_launch_table_matches_repro_pallas_calls(step, monkeypatch):
    """The atrous loss and the example's step launch what `repro`'s same
    calls on `pallas` count as pallas_calls (7 and 10), kernel by kernel.
    Patchify launches one more: its plain S = 14 forward takes the
    dconv_forward kernel, which `repro` sends to XLA (ROADMAP C)."""
    table = _smoke_table("VISION_LAUNCHES")[step]
    fn, args, _ = _vision_cases()[step]
    counts = _counting(monkeypatch, jops, _PALLAS)
    n = count_pallas_calls(fn, *args)
    if step == "patchify":
        assert dict(counts) == {"conv_backward": 1} and n == 1
        assert table == {"dconv_forward": 1, "conv_backward": 1}
    else:
        assert dict(counts) == table
        assert n == sum(table.values()) == {"atrous_seg_loss": 7,
                                            "segment_atrous_step": 10}[step]


@pytest.mark.parametrize("step", ["atrous_seg_loss", "segment_atrous_step",
                                  "patchify"])
def test_port_vision_calls_each_kernel_as_the_table_says(step, monkeypatch):
    counts = _counting(monkeypatch, tops, _PLAIN)
    _vision_cases()[step][2]()
    assert dict(counts) == _smoke_table("VISION_LAUNCHES")[step]
