"""The port's MoE layer (`repro_torch/models/moe.py`) on the CPU against
`repro/models/moe.py`.

  * `tests/test_moe.py`'s four properties on the port: ample capacity
    equals the dense per-token top-k mixture (shared experts 0 and 1);
    a capacity too small drops tokens; the capacity formula; a uniform
    router -- every token's probabilities tie -- gives aux == 1.
  * `route` puts the lower expert first on a tie, as `jax.lax.top_k`
    does, and the slots it leads to are `repro`'s one-hot dispatch.
  * `moe_block`'s output, aux loss and every gradient (params and input)
    against `jax.vjp` of `repro`'s, with ample and with tight capacity
    (tokens dropped), and with ties.
  * The decode grouping: one token per row routes over the batch.

Inputs and params come from numpy seeds.  Tolerance: fp32 rtol = atol =
1e-4 for values; gradients within 1e-3 of each leaf's largest magnitude.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import assert_allclose
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig

TOL = 1e-4
GRAD_TOL = 1e-3


def _cfgs(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=16, d_ff=32,
                vocab=64, n_experts=4, top_k=2, moe_dff=32,
                capacity_factor=8.0)
    base.update(kw)
    jcfg = JConfig(**base)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0, zero_router=False):
    """numpy params of `repro`'s init plus seeded noise."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    out = {k: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in p.items()}
    if zero_router:
        out["router"] = np.zeros_like(out["router"])
    return out


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _dense_reference(params, x, cfg):
    """Every token through its top-k experts, no capacity limit."""
    probs = torch.softmax(x @ params["router"], -1)
    gv, gi = torch.topk(probs, cfg.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = F.silu(x @ params["experts_wg"][e]) * (x @ params["experts_wi"][e])
        w_e = (gv * (gi == e)).sum(-1)
        out = out + w_e[..., None] * (h @ params["experts_wo"][e])
    if cfg.n_shared_experts:
        hs = F.silu(x @ params["shared_wg"]) * (x @ params["shared_wi"])
        out = out + hs @ params["shared_wo"]
    return out


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_matches_dense_with_ample_capacity(shared):
    jcfg, cfg = _cfgs(n_shared_experts=shared)
    params = _torch(_params(jcfg))
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    out, aux = tmoe.moe_block(params, x, cfg)
    assert_allclose(out, _dense_reference(params, x, cfg), rtol=TOL,
                    atol=TOL)
    assert float(aux) >= 1.0 - 1e-5   # Switch aux loss lower bound is 1


def test_moe_capacity_drops_overflow():
    jcfg, cfg = _cfgs(capacity_factor=1e-6)   # floor -> minimum capacity
    params = _torch(_params(jcfg))
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_block(params, x, cfg)
    per_tok = (out - _dense_reference(params, x, cfg)).abs().sum(-1)
    assert bool(torch.isfinite(out).all()) and float(out.abs().sum()) > 0.0
    assert bool((per_tok > 1e-3).any())


def test_capacity_formula():
    jcfg, cfg = _cfgs(capacity_factor=1.25)
    assert tmoe.capacity(cfg, 128) == jmoe.capacity(jcfg, 128) == 80
    for seq in (1, 4, 7, 64, 1000):
        assert tmoe.capacity(cfg, seq) == jmoe.capacity(jcfg, seq) >= 4


def test_aux_loss_balanced_router_is_minimal():
    """A uniform router ties every token's probabilities: aux == 1, as
    `repro`'s; the top-k are experts 0..k-1 in order, as `lax.top_k`."""
    jcfg, cfg = _cfgs()
    np_params = _params(jcfg, zero_router=True)
    x = np.random.default_rng(3).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    out, aux = tmoe.moe_block(_torch(np_params), torch.tensor(x), cfg)
    assert abs(float(aux) - 1.0) < 0.05
    jout, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, np_params),
                                jnp.asarray(x), jcfg)
    assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    assert_allclose(out, jout, rtol=TOL, atol=TOL)
    _, _, idx = tmoe.route(_torch(np_params), torch.tensor(x), cfg)
    assert (idx == torch.arange(cfg.top_k)).all()


def test_route_breaks_ties_toward_the_lower_expert():
    """Rows with equal probabilities (logits set through one-hot tokens):
    `route`'s top-k order is `jax.lax.top_k`'s."""
    _, cfg = _cfgs(d_model=4, top_k=3)
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    x = torch.eye(4)[None, :3]                   # token i reads router row i
    router = torch.zeros((4, 4))
    router[:3] = torch.log(torch.tensor(probs))
    _, _, idx = tmoe.route({"router": router}, x, cfg)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    assert idx[0].tolist() == np.asarray(jidx).tolist()


@pytest.mark.parametrize("cap,shared", [(8.0, 1), (0.5, 0)],
                         ids=["ample", "tight"])
def test_slots_are_repros_dispatch(cap, shared):
    """Each kept choice's slot is the one `repro`'s one-hot dispatch puts
    it in, and the dropped ones are the same."""
    jcfg, cfg = _cfgs(capacity_factor=cap, n_shared_experts=shared)
    params = _torch(_params(jcfg, 4))
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    _, _, idx = tmoe.route(params, x, cfg)
    C = tmoe.capacity(cfg, 24)
    slot = tmoe.slots(idx, cfg, C)
    onehot = jax.nn.one_hot(jnp.asarray(idx.numpy()), cfg.n_experts,
                            dtype=jnp.int32)
    flat = onehot.reshape(2, 24 * cfg.top_k, cfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    in_cap = (pos < C) & (onehot > 0)
    want = np.full(idx.shape, cfg.n_experts * C)
    for b, s, k, e in zip(*np.nonzero(np.asarray(in_cap))):
        want[b, s, k] = e * C + int(pos[b, s, k, e])
    assert slot.tolist() == want.tolist()
    if cap < 1:
        assert (slot == cfg.n_experts * C).any()


@pytest.mark.parametrize("cap,shared,zero_router", [
    (8.0, 1, False), (0.5, 0, False), (1.0, 1, True)],
    ids=["ample", "tight", "ties"])
def test_moe_block_and_gradients_match_jax_vjp(cap, shared, zero_router):
    jcfg, cfg = _cfgs(capacity_factor=cap, n_shared_experts=shared,
                      n_experts=8, top_k=3)
    np_params = _params(jcfg, 5, zero_router)
    x = np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    dout = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)

    def jfn(p, a):
        return jmoe.moe_block(p, a, jcfg)

    @jax.jit
    def fwd_bwd(p, a):
        outs, vjp = jax.vjp(jfn, p, a)
        return outs, vjp((jnp.asarray(dout), jnp.float32(0.7)))

    (jout, jaux), (jgp, jgx) = fwd_bwd(np_params, x)

    tp = {k: v.requires_grad_() for k, v in _torch(np_params).items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_block(tp, tx, cfg)
    assert_allclose(out.detach(), jout, rtol=TOL, atol=TOL)
    assert_allclose(float(aux.detach()), float(jaux), rtol=TOL, atol=TOL)
    ((out * torch.tensor(dout)).sum() + 0.7 * aux).backward()
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = tx.grad if name == "x" else tp[name].grad
        want = np.asarray(want)
        atol = GRAD_TOL * float(np.abs(want).max())
        assert_allclose(got, want, rtol=GRAD_TOL, atol=atol, err_msg=name)


def test_decode_groups_over_the_batch():
    """One token per row (S == 1): the block routes the B tokens as one
    group of capacity `capacity(cfg, B)`, as `repro`'s decode does by
    transposing; 16 tokens at capacity 4 a expert drop some."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    np_params = _params(jcfg, 7)
    x = np.random.default_rng(7).standard_normal(
        (16, 1, cfg.d_model)).astype(np.float32)
    got, aux = tlm._ffn({"moe": _torch(np_params)}, torch.tensor(x), cfg)
    want, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, np_params),
                                jnp.asarray(x).transpose(1, 0, 2), jcfg)
    assert got.shape == (16, 1, cfg.d_model)
    assert_allclose(got, np.asarray(want).transpose(1, 0, 2), rtol=TOL,
                    atol=TOL)
    assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    # Routed per row instead, each token would have a whole group's slots.
    alone, _ = tmoe.moe_block(_torch(np_params), torch.tensor(x), cfg)
    assert not torch.allclose(alone, got, rtol=TOL, atol=TOL)
