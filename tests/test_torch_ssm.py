"""The port's linear-attention / SSM substrate (`repro_torch/models/ssm.py`)
on the CPU against `repro/models/ssm.py`.

  * `tests/test_linear_attention.py` on the port: the chunked scan
    against the recurrent oracle over chunk {4, 16, 64} x pre_update
    (S not a multiple of the chunk), chunk-size invariance, the state
    carried across two segments, extreme decay staying finite, and
    `causal_conv1d` and its one-step form.
  * Each function against `repro`'s on the same numpy inputs: the
    chunked scan with u and a start state, the decode step, the conv
    pair, and every Mamba2 and RWKV6 function, with the gradients of
    `mamba2_block` and of RWKV6's time and channel mix against
    `jax.vjp`.

Tolerance: fp32 rtol = atol = 1e-4 between the two packages (2e-4
against the recurrent oracle, as `repro`'s own test); gradients within
1e-3 of each leaf's largest magnitude.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig

TOL = 1e-4
ORACLE_TOL = 2e-4
GRAD_TOL = 1e-3


def _inputs(seed, B, S, H, dk, dv, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    log_w = (-decay_scale * rng.uniform(0.01, 1.0, (B, S, H, dk))).astype(
        np.float32)
    return q, k, v, log_w


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


# -- tests/test_linear_attention.py on the port ------------------------------

@pytest.mark.parametrize("pre_update", [False, True])
@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_chunked_matches_recurrent(pre_update, chunk):
    B, S, H, dk, dv = 2, 33, 3, 8, 8   # S not a multiple of chunk
    q, k, v, log_w = _t(*_inputs(chunk, B, S, H, dk, dv))
    u = torch.tensor(np.random.default_rng(1).standard_normal(
        (H, dk)).astype(np.float32)) if pre_update else None
    y, st = tssm.chunked_linear_attention(q, k, v, log_w, chunk=chunk, u=u,
                                          pre_update_read=pre_update)
    y_ref, st_ref = tssm.recurrent_reference(q, k, v, log_w, u=u,
                                             pre_update_read=pre_update)
    assert_allclose(y, y_ref, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    assert_allclose(st, st_ref, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_chunk_size_invariance():
    q, k, v, log_w = _t(*_inputs(2, 1, 48, 2, 4, 4))
    outs = [tssm.chunked_linear_attention(q, k, v, log_w, chunk=c)[0]
            for c in (4, 8, 24, 48)]
    for o in outs[1:]:
        assert_allclose(o, outs[0], rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_state_carry_across_segments():
    """[0:S/2] then [S/2:S] with the carried state equals one pass -- the
    property the prefill / decode handoff relies on."""
    q, k, v, log_w = _t(*_inputs(3, 1, 32, 2, 4, 4))
    y_full, st_full = tssm.chunked_linear_attention(q, k, v, log_w, chunk=8)
    h = 16
    y1, st1 = tssm.chunked_linear_attention(q[:, :h], k[:, :h], v[:, :h],
                                            log_w[:, :h], chunk=8)
    y2, st2 = tssm.chunked_linear_attention(q[:, h:], k[:, h:], v[:, h:],
                                            log_w[:, h:], chunk=8,
                                            state0=st1)
    assert_allclose(torch.cat([y1, y2], 1), y_full, rtol=ORACLE_TOL,
                    atol=ORACLE_TOL)
    assert_allclose(st2, st_full, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_extreme_decay_is_finite():
    q, k, v, _ = _t(*_inputs(4, 1, 16, 1, 4, 4))
    log_w = torch.full((1, 16, 1, 4), -1e4)
    y, st = tssm.chunked_linear_attention(q, k, v, log_w, chunk=8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


def test_causal_conv1d_and_its_step():
    rng = np.random.default_rng(5)
    B, S, C, K = 2, 20, 6, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    y = tssm.causal_conv1d(torch.tensor(x), torch.tensor(w))
    xp = np.zeros((B, S + K - 1, C))
    xp[:, K - 1:] = x
    want = sum(xp[:, kk:kk + S] * w[kk] for kk in range(K))
    assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    assert_allclose(y, jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w)),
                    rtol=TOL, atol=TOL)
    state = torch.zeros((B, K - 1, C))
    ys = []
    for t in range(S):
        yt, state = tssm.causal_conv1d_step(torch.tensor(x[:, t]), state,
                                            torch.tensor(w))
        ys.append(yt)
    assert_allclose(torch.stack(ys, 1), y, rtol=1e-5, atol=1e-5)
    jy, jstate = jssm.causal_conv1d_step(jnp.asarray(x[:, -1]),
                                         jnp.asarray(x[:, -4:-1]),
                                         jnp.asarray(w))
    ty, tstate = tssm.causal_conv1d_step(torch.tensor(x[:, -1]),
                                         torch.tensor(x[:, -4:-1]),
                                         torch.tensor(w))
    assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    assert_allclose(tstate, jstate, rtol=0, atol=0)


# -- against repro --------------------------------------------------------------

@pytest.mark.parametrize("pre_update", [False, True])
def test_chunked_and_decode_match_repro(pre_update):
    B, S, H, dk, dv = 2, 37, 3, 8, 4
    arrays = _inputs(6, B, S, H, dk, dv)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((H, dk)).astype(np.float32) \
        if pre_update else None
    s0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    kw = dict(chunk=16, pre_update_read=pre_update)
    y, st = tssm.chunked_linear_attention(
        *_t(*arrays), u=None if u is None else torch.tensor(u),
        state0=torch.tensor(s0), **kw)
    jy, jst = jssm.chunked_linear_attention(
        *(jnp.asarray(a) for a in arrays),
        u=None if u is None else jnp.asarray(u), state0=jnp.asarray(s0), **kw)
    assert_allclose(y, jy, rtol=TOL, atol=TOL)
    assert_allclose(st, jst, rtol=TOL, atol=TOL)
    step = [a[:, 5] for a in arrays]
    y1, st1 = tssm.linear_attention_decode(
        *_t(*step), torch.tensor(s0),
        u=None if u is None else torch.tensor(u), pre_update_read=pre_update)
    jy1, jst1 = jssm.linear_attention_decode(
        *(jnp.asarray(a) for a in step), jnp.asarray(s0),
        u=None if u is None else jnp.asarray(u), pre_update_read=pre_update)
    assert_allclose(y1, jy1, rtol=TOL, atol=TOL)
    assert_allclose(st1, jst1, rtol=TOL, atol=TOL)


def _cfgs(arch):
    jcfg = j_get_smoke_config(arch).scaled(dtype="float32")
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in tree.items()}


def _vjp_check(jfn, tfn, np_params, x, seed):
    """Outputs and every gradient (params, x) of `tfn` against
    `jax.vjp(jfn)` at a seeded cotangent per output."""
    shapes = jax.eval_shape(jfn, np_params, x)
    rng = np.random.default_rng(seed)
    cots = tuple(rng.standard_normal(o.shape).astype(np.float32)
                 for o in shapes)

    @jax.jit
    def fwd_bwd(p, a, c):
        outs, vjp = jax.vjp(jfn, p, a)
        return outs, vjp(c)

    jouts, (jgp, jgx) = fwd_bwd(np_params, x, cots)
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in np_params.items()}
    tx = torch.tensor(x, requires_grad=True)
    touts = tfn(tp, tx)
    for got, want in zip(touts, jouts):
        assert_allclose(got.detach(), want, rtol=TOL, atol=TOL)
    sum((o * torch.tensor(c)).sum() for o, c in zip(touts, cots)).backward()
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = tx.grad if name == "x" else tp[name].grad
        want = np.asarray(want)
        if got is None:
            assert not want.any(), name
            continue
        atol = GRAD_TOL * float(np.abs(want).max())
        assert_allclose(got, want, rtol=GRAD_TOL, atol=atol, err_msg=name)


def test_mamba2_functions_match_repro():
    jcfg, cfg = _cfgs("zamba2_2_7b")
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg)
    tp = tssm.mamba2_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    np_params = _noisy(jp, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    _vjp_check(lambda p, a: (jssm.mamba2_block(p, a, jcfg),),
               lambda p, a: (tssm.mamba2_block(p, a, cfg),), np_params, x, 3)
    # The pieces the prefill and decode share.
    jparts = jssm._mamba_parts(jax.tree.map(jnp.asarray, np_params),
                               jnp.asarray(x), jcfg)
    tparams = {k: torch.tensor(v) for k, v in np_params.items()}
    tparts = tssm._mamba_parts(tparams, torch.tensor(x), cfg)
    for got, want in zip(tparts[:3], jparts[:3]):
        assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tparts[3:] == jparts[3:]
    for got, want in zip(
            tssm._mamba_ssm_inputs(tparams, *tparts[1:3], cfg, *tparts[3:]),
            jssm._mamba_ssm_inputs(jax.tree.map(jnp.asarray, np_params),
                                   *jparts[1:3], jcfg, *jparts[3:])):
        assert_allclose(got, want, rtol=TOL, atol=TOL)
    # One decode step from a random conv and SSM state.
    C = jcfg.d_inner + 2 * jcfg.ssm_state
    H = jcfg.d_inner // jcfg.ssm_head_dim
    conv = rng.standard_normal((2, jcfg.ssm_conv - 1, C)).astype(np.float32)
    st = rng.standard_normal((2, H, jcfg.ssm_state, jcfg.ssm_head_dim)
                             ).astype(np.float32)
    got = tssm.mamba2_decode(tparams, torch.tensor(x[:, :1]), cfg,
                             torch.tensor(conv), torch.tensor(st))
    want = jssm.mamba2_decode(jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(x[:, :1]), jcfg, jnp.asarray(conv),
                              jnp.asarray(st))
    for g, w in zip(got, want):
        assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_rwkv6_functions_match_repro():
    jcfg, cfg = _cfgs("rwkv6_7b")
    jp = jssm.rwkv6_init(jax.random.PRNGKey(0), jcfg)
    tp = tssm.rwkv6_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    np_params = _noisy(jp, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    _vjp_check(lambda p, a: jssm.rwkv6_time_mix(p, a, jcfg,
                                                jnp.asarray(prev)),
               lambda p, a: tssm.rwkv6_time_mix(p, a, cfg,
                                                torch.tensor(prev)),
               np_params, x, 6)
    _vjp_check(lambda p, a: jssm.rwkv6_channel_mix(p, a, jcfg),
               lambda p, a: tssm.rwkv6_channel_mix(p, a, cfg),
               np_params, x, 7)
    H = jcfg.d_model // jcfg.ssm_head_dim
    st = rng.standard_normal((2, H, jcfg.ssm_head_dim, jcfg.ssm_head_dim)
                             ).astype(np.float32)
    tparams = {k: torch.tensor(v) for k, v in np_params.items()}
    got = tssm.rwkv6_time_mix_decode(tparams, torch.tensor(x[:, :1]), cfg,
                                     torch.tensor(prev), torch.tensor(st))
    want = jssm.rwkv6_time_mix_decode(jax.tree.map(jnp.asarray, np_params),
                                      jnp.asarray(x[:, :1]), jcfg,
                                      jnp.asarray(prev), jnp.asarray(st))
    for g, w in zip(got, want):
        assert_allclose(g, w, rtol=TOL, atol=TOL)
    got = tssm.rwkv6_channel_mix(tparams, torch.tensor(x[:, :1]), cfg,
                                 torch.tensor(prev))
    want = jssm.rwkv6_channel_mix(jax.tree.map(jnp.asarray, np_params),
                                  jnp.asarray(x[:, :1]), jcfg,
                                  jnp.asarray(prev))
    for g, w in zip(got, want):
        assert_allclose(g, w, rtol=TOL, atol=TOL)
