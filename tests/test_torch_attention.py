"""The port's flash attention on the CPU against `repro`.

  * `ops.flash_attention` on CPU tensors (its plain version) against
    `repro`'s Pallas kernel in interpret mode and `repro`'s dense oracle
    over `test_kernels.ATTN_SWEEP` (copied to `_torch_cases` for the
    card's tests; pinned equal here), in fp32 and in bf16.
  * `models.layers.flash_attention` against `repro`'s chunked
    `models/layers.py::flash_attention` with chunks shorter than Sk and a
    `q_offset`.
  * What the wrapper refuses.

Inputs come from numpy seeds.  Tolerance: fp32 at rtol = atol = 2e-5,
the bound of `repro`'s own sweep (`test_kernels.py`); bf16 at 5e-2
(DESIGN.md Sec. 2.3).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ATTN_SWEEP, attention_case
from conftest import assert_allclose
from repro.kernels import ref as jref
from repro.kernels.attention import flash_attention_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.attention import check_operand, flash_attention_plain
from repro_torch.models import layers as tlayers
from test_kernels import ATTN_SWEEP as REPRO_ATTN_SWEEP

TOL = 2e-5
BF16_TOL = 5e-2


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def test_attention_sweep_copy_matches_repro():
    assert ATTN_SWEEP == REPRO_ATTN_SWEEP


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,bq,bk", ATTN_SWEEP)
def test_plain_matches_pallas_kernel_and_oracle(B, Sq, Sk, Hq, Hk, D,
                                                causal, bq, bk):
    q, k, v = attention_case(B, Sq, Sk, Hq, Hk, D, seed=Sq * 100 + Sk)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tops.reset_launches()
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert tops.LAUNCHES["flash_attention"] == 0      # plain: no launch
    assert torch.equal(got, flash_attention_plain(tq, tk, tv, causal=causal))
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, blk_q=bq,
                                    blk_k=bk, interpret=True)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    # The port's oracle, and the plain version blocked as the Pallas
    # kernel was.
    assert_allclose(tref.flash_attention_ref(tq, tk, tv, causal=causal),
                    want, rtol=TOL, atol=TOL)
    assert_allclose(flash_attention_plain(tq, tk, tv, causal=causal,
                                          blk_k=bk), pallas, rtol=TOL,
                    atol=TOL)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D", [(2, 64, 64, 4, 4, 32),
                                             (1, 3, 50, 8, 2, 64)])
def test_bf16_matches_pallas_kernel(B, Sq, Sk, Hq, Hk, D):
    q, k, v = attention_case(B, Sq, Sk, Hq, Hk, D, seed=7)
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention_pallas(jq, jk, jv, blk_q=32, blk_k=32,
                                    interpret=True)
    assert_allclose(_f32(got), _f32(pallas), rtol=BF16_TOL, atol=BF16_TOL)
    assert_allclose(_f32(got), _f32(jref.flash_attention_ref(jq, jk, jv)),
                    rtol=BF16_TOL, atol=BF16_TOL)


# (B, Sq, Sk, Hq, Hk, D, causal, chunk, q_offset)
LAYER_CASES = [
    (2, 40, 40, 4, 2, 16, True, 16, 0),      # prefill, ragged last chunk
    (1, 5, 37, 4, 1, 32, True, 8, 32),       # decode-style suffix, MQA
    (2, 1, 29, 8, 2, 16, True, 8, 28),       # one query over a cache
    (1, 9, 23, 4, 4, 16, False, 8, 0),       # non-causal
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,chunk,q_offset",
                         LAYER_CASES)
def test_layers_flash_attention_matches_repro(B, Sq, Sk, Hq, Hk, D, causal,
                                              chunk, q_offset):
    q, k, v = attention_case(B, Sq, Sk, Hq, Hk, D, seed=Sk)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tlayers.flash_attention(tq, tk, tv, causal=causal, chunk=chunk,
                                  q_offset=q_offset)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   chunk=chunk, q_offset=q_offset)
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    # On the CPU the layer is the wrapper's plain version over its chunks.
    assert torch.equal(got, flash_attention_plain(
        tq, tk, tv, causal=causal, q_offset=q_offset, blk_k=chunk))
    # The wrapper takes the same q_offset (its kernel's blocks differ).
    assert_allclose(tops.flash_attention(tq, tk, tv, causal=causal,
                                         q_offset=q_offset), want,
                    rtol=TOL, atol=TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 4, 4, 32))
    kv = torch.zeros((1, 4, 2, 32))
    with pytest.raises(TypeError):
        tops.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        tops.flash_attention(q.bfloat16(), kv, kv)            # mixed dtypes
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention(q, torch.zeros((1, 4, 3, 32)),
                             torch.zeros((1, 4, 3, 32)))
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(torch.zeros((1, 4, 4, 48)),
                             torch.zeros((1, 4, 2, 48)),
                             torch.zeros((1, 4, 2, 48)))
    with pytest.raises(ValueError, match="q_offset"):
        tops.flash_attention(torch.zeros((1, 8, 4, 32)), kv, kv)  # Sq > Sk
    with pytest.raises(ValueError, match="one device"):
        tops.flash_attention(q, kv.to("meta"), kv)
    with pytest.raises(ValueError, match="expected"):
        tops.flash_attention(q, kv, torch.zeros((1, 5, 2, 32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_operand_check(dtype):
    """What the kernel reads in place (the live prefix of a KV cache) and
    what the launcher refuses instead of copying."""
    cache = torch.zeros((3, 96, 2, 128), dtype=dtype)
    check_operand("k", cache[:, :71])                 # strided, aligned
    check_operand("q", torch.zeros((3, 1, 8, 128), dtype=dtype))
    with pytest.raises(ValueError, match="unit stride"):
        check_operand("k", cache.transpose(1, 3))
    flat = torch.zeros(cache.numel() + 1, dtype=dtype)
    with pytest.raises(ValueError, match="aligned"):
        check_operand("k", flat[1:].view(cache.shape))
    with pytest.raises(ValueError, match="multiples"):
        check_operand("v", torch.zeros((3, 96, 2, 132), dtype=dtype)[..., :128]
                      if dtype == torch.bfloat16 else
                      torch.zeros((3, 96, 2, 130), dtype=dtype)[..., :128])
