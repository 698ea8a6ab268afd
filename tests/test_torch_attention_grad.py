"""The attention gradient of the port on the CPU against `repro`.

  * `flash_attention_backward_plain` (the backward kernel's plain version,
    block-wise with the kernel's formulas) from `flash_attention_plain`'s
    output and lse equals `jax.vjp` of `repro.models.layers.
    flash_attention` on the same numpy q, k, v and cotangent: fp32 and
    bf16, g = 1 and 2, causal or not, Sq = Sk and Sq < Sk with a
    q_offset (at Sk - Sq and below it, so that some keys are seen by no
    query), ragged lengths against the kv block.
  * The lse `flash_attention_plain(return_lse=True)` gives is the
    log-sum-exp of the masked scaled scores.
  * `ops.flash_attention` with an operand that requires grad goes
    through `FlashAttentionFn`, whose CPU backward is the plain backward.

Tolerance: fp32 at rtol = atol = 1e-4 (the two sides sum in other
orders); bf16 at 5e-2 of each gradient's largest magnitude: `repro`
differentiates through its fp32 recurrence and rounds once, the port
takes delta from the bf16 output, so entries near zero carry the
rounding of the largest terms of their sums.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.models import layers as jL
from repro_torch.kernels import ops
from repro_torch.kernels.attention import (flash_attention_backward_plain,
                                           flash_attention_plain)

TOL = 1e-4
BF16_TOL = 5e-2

# (B, Sq, Sk, Hq, Hk, D, causal, q_offset)
GRAD_GRID = [
    (2, 37, 37, 2, 2, 16, True, 0),       # g = 1, ragged, Sq = Sk
    (1, 40, 40, 4, 2, 32, True, 0),       # g = 2
    (1, 20, 50, 4, 2, 16, True, 30),      # Sq < Sk, q_offset = Sk - Sq
    (1, 20, 50, 4, 1, 16, True, 17),      # MQA; keys past 36 unseen
    (1, 33, 70, 4, 2, 16, False, 0),      # no mask, Sq < Sk
    (2, 65, 65, 4, 2, 16, False, 0),      # no mask, ragged
]


def _operands(case, seed):
    B, Sq, Sk, Hq, Hk, D, _, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D),
                           (B, Sq, Hq, D)))


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        assert_allclose(got.float(), want, rtol=TOL, atol=TOL)
    else:
        atol = BF16_TOL * float(np.abs(want).max())
        assert_allclose(got.float(), want, rtol=BF16_TOL, atol=atol)


@jax.jit(static_argnums=(0, 1))
def _jax_vjp(causal, off, q, k, v, do):
    out, vjp = jax.vjp(lambda a, b, c: jL.flash_attention(
        a, b, c, causal=causal, chunk=16, q_offset=off), q, k, v)
    return out, vjp(do)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_GRID,
                         ids=["-".join(map(str, c)) for c in GRAD_GRID])
def test_backward_plain_matches_jax_grad(case, dtype):
    *_, causal, off = case
    q, k, v, do = _operands(case, 1)
    jdt = getattr(jnp, dtype)
    jout, want = _jax_vjp(causal, off, *(jnp.asarray(a, jdt)
                                         for a in (q, k, v, do)))
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(a).to(tdt) for a in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, q_offset=off,
                                     blk_k=16, return_lse=True)
    _close(out, jout, dtype)
    got = flash_attention_backward_plain(tq, tk, tv, out, tdo, lse,
                                         causal=causal, q_offset=off,
                                         blk_k=16)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("case", GRAD_GRID,
                         ids=["-".join(map(str, c)) for c in GRAD_GRID])
def test_lse_is_the_log_sum_exp_of_the_visible_scores(case):
    B, Sq, Sk, Hq, Hk, D, causal, off = case
    q, k, v, _ = (torch.tensor(a) for a in _operands(case, 2))
    _, lse = flash_attention_plain(q, k, v, causal=causal, q_offset=off,
                                   blk_k=16, return_lse=True)
    kk = k.repeat_interleave(Hq // Hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, kk)
    if causal:
        visible = torch.arange(Sk)[None, :] <= off + torch.arange(Sq)[:, None]
        s = s.masked_fill(~visible, float("-inf"))
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert_allclose(lse, torch.logsumexp(s, dim=-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blk_k", [16, 64])
def test_flash_attention_function_on_the_cpu(blk_k):
    """Operands that require grad take `FlashAttentionFn`: its backward
    on the CPU is the plain backward exactly, it agrees with autograd
    through the plain forward, and it launches nothing."""
    case = (1, 40, 40, 4, 2, 32, True, 0)
    q, k, v, do = (torch.tensor(a) for a in _operands(case, 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, causal=True, blk_k=blk_k)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    _, lse = flash_attention_plain(q, k, v, blk_k=blk_k, return_lse=True)
    want = flash_attention_backward_plain(q, k, v, out.detach(), do, lse,
                                          causal=True, q_offset=0,
                                          blk_k=blk_k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_plain(*ref_leaves,
                                                    blk_k=blk_k),
                              ref_leaves, do)
    for g, r in zip(got, ref):
        assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    assert not any(ops.LAUNCHES.values())
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    assert ops.flash_attention(q, k, v).grad_fn is None


def test_the_function_takes_a_q_offset_and_gqa_through_autograd():
    """The Function inside a larger graph: a loss on a transposed view of
    the output (a strided cotangent) against autograd of the plain
    forward, with MQA and q_offset."""
    case = (1, 20, 50, 4, 1, 16, True, 17)
    q, k, v, _ = (torch.tensor(a) for a in _operands(case, 4))
    w = torch.tensor(np.random.default_rng(5).standard_normal(
        (1, 4, 20, 16)).astype(np.float32))

    def loss(fn, leaves):
        out = fn(*leaves, causal=True, q_offset=17, blk_k=16)
        return (out.transpose(1, 2) * w).sum()

    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(loss(ops.flash_attention, a), a)
    want = torch.autograd.grad(loss(flash_attention_plain, b), b)
    for g, r in zip(got, want):
        assert_allclose(g, r, rtol=1e-5, atol=1e-5)
