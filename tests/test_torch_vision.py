"""The port's vision modules (`repro_torch/models/vision.py`) on the CPU
against `repro/models/vision.py`, on `repro`'s params (copied through
`convert.params_from_numpy`) and the same numpy inputs:

  * the atrous head's logits, with the branch relu fused into the
    epilogue and as a separate op;
  * `atrous_seg_loss` and every gradient (in 2, width 4, rates (1, 2),
    11x11, as tests/test_cnn_gan.py), on the port's `cuda` backend (the
    kernels' plain versions on CPU tensors) and on `torch_zero_free`,
    against `repro`'s `reference` backend;
  * patchify at patch 14 (S = K = 14), 56x56, d_model 32: the
    embeddings and the gradient of sum(out^2) in `proj` and `pos`;
  * `atrous_plan_requests` equal to `repro`'s, entry for entry.

Tolerance: rtol 1e-4, atol 1e-5 (fp32, sums in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.models import vision as tvision
from repro_torch.models.layers import sgd_grads

RTOL, ATOL = 1e-4, 1e-5
RATES = (1, 2)
BACKENDS = ["cuda", "torch_zero_free"]


def _repro_tree(init, seed, **kw):
    """A param tree in `repro`'s layout (keys and shapes from
    jax.eval_shape), filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)


@pytest.fixture(scope="module")
def head():
    params = _repro_tree(jvision.atrous_head_init, 0, in_ch=2, width=4,
                         n_classes=3, rates=RATES)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 11, 2)).astype(np.float32)
    y = rng.integers(0, 3, (2, 11, 11)).astype(np.int32)
    return params, x, y


def _hold_grads(got, want):
    for k in want:
        assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("fuse", [True, False])
def test_atrous_head_apply_matches_repro(head, fuse):
    params, x, _ = head
    want = jvision.atrous_head_apply(params, jnp.asarray(x), rates=RATES,
                                     backend="reference",
                                     fuse_epilogue=fuse)
    with torch.no_grad():
        got = tvision.atrous_head_apply(
            params_from_numpy(params, "cpu"), torch.tensor(x), rates=RATES,
            backend="cuda", fuse_epilogue=fuse)
    assert tuple(got.shape) == (2, 11, 11, 3)
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_atrous_seg_loss_and_grads_match_repro(head, backend, fuse):
    params, x, y = head
    want_loss, want_g = jax.value_and_grad(
        lambda p: jvision.atrous_seg_loss(
            p, jnp.asarray(x), jnp.asarray(y), rates=RATES,
            backend="reference", fuse_epilogue=fuse))(params)
    loss, grads = sgd_grads(
        lambda p: tvision.atrous_seg_loss(
            p, torch.tensor(x), torch.tensor(y), rates=RATES,
            backend=backend, fuse_epilogue=fuse),
        params_from_numpy(params, "cpu"))
    assert loss.dim() == 0
    assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    assert set(grads) == set(want_g) == {"rate1", "rate2", "fuse"}
    _hold_grads(grads, want_g)


@pytest.mark.parametrize("backend", BACKENDS)
def test_patchify_forward_and_grads_match_repro(backend):
    params = _repro_tree(jvision.patchify_init, 2, patch=14, d_model=32)
    img = np.random.default_rng(3).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jvision.patchify_apply(p, jnp.asarray(img), patch=14,
                                              backend="reference") ** 2)

    want_out = jvision.patchify_apply(params, jnp.asarray(img), patch=14,
                                      backend="reference")
    want_g = jax.grad(jloss)(params)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        out = tvision.patchify_apply(tp, torch.tensor(img), patch=14,
                                     backend=backend)
    assert tuple(out.shape) == (2, 16, 32)     # (56 / 14)^2 patches
    assert_allclose(out, want_out, rtol=RTOL, atol=ATOL)
    _, grads = sgd_grads(lambda p: torch.sum(tvision.patchify_apply(
        p, torch.tensor(img), patch=14, backend=backend) ** 2), tp)
    assert set(grads) == {"proj", "pos"}
    for k in grads:   # sums of order 10^3: held relative to their scale
        scale = float(np.abs(np.asarray(want_g[k])).max())
        assert_allclose(grads[k], want_g[k], rtol=RTOL, atol=ATOL * scale,
                        err_msg=k)


def test_inits_give_repro_shapes():
    gen = torch.Generator().manual_seed(0)
    for init, jinit, kw in (
            (tvision.patchify_init, jvision.patchify_init,
             dict(patch=14, d_model=32)),
            (tvision.atrous_head_init, jvision.atrous_head_init,
             dict(in_ch=2, width=4, n_classes=3, rates=RATES))):
        got = init(gen, device="cpu", **kw)
        want = jax.eval_shape(lambda k: jinit(k, **kw),
                              jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())


@pytest.mark.parametrize("fuse", [True, False])
def test_atrous_plan_requests_match_repro(head, fuse):
    params = head[0]
    want = jvision.atrous_plan_requests(params, (4, 16, 16, 2), rates=RATES,
                                        fuse_epilogue=fuse)
    got = tvision.atrous_plan_requests(params_from_numpy(params, "cpu"),
                                       (4, 16, 16, 2), rates=RATES,
                                       fuse_epilogue=fuse)
    assert len(got) == len(want) == len(RATES) + 1
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:4] == w[2:4]
        for f in ("stride", "padding", "filter_shape", "dilation"):
            assert getattr(g[1], f) == getattr(w[1], f)
        assert (g[4] is None and w[4] is None) or g[4].tag == w[4].tag
