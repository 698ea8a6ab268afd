"""The port's dense LM serving path on the CPU against `repro`.

  * Configs: the four dense configs equal `repro`'s field for field; the
    audio and vlm ids refuse (the other families:
    `test_torch_lm_families.py`).
  * Params: `LM(cfg).init` gives `repro`'s tree (keys, shapes, dtypes),
    and `params_from_numpy` carries `repro`'s params across unchanged.
  * Layers: `rmsnorm`, `rope`, `_qkv`, `attention_block`,
    `attention_decode`, `mlp_block` (swiglu / geglu / gelu), `embed` and
    `logits_head` against `repro` on the same numpy params and inputs.
  * Model: `LM.prefill` and 4 `decode_step`s (logits and cache) against
    `repro` at the SMOKE configs of qwen3-0.6b, qwen2-1.5b and gemma-2b in
    fp32, plus one bf16 run; the port's own teacher forcing (prefill S+1
    equals prefill S and one decode).
  * Engine: the same requests through both `ServeEngine`s give the same
    tokens and stats, with a mid-flight refill; the launcher runs.

Params are `repro`'s init plus seeded numpy noise on every leaf (so norm
scales and biases are not zero).  Tolerance: fp32 at rtol = atol = 1e-4
(DESIGN.md Sec. 2.3; the two sides sum in other orders); bf16 at 5e-2,
for the whole model at 5e-2 of the output's largest magnitude: its
logits and cache come out of bf16 matmuls that the two frameworks round
at other places, so an entry near zero carries the absolute rounding of
the largest terms of its sum (measured: 2 bf16 ulps at |logit| ~ 32).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import layers as jL
from repro.models.lm import LM as JLM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4
BF16_TOL = 5e-2
DENSE = ["qwen3_0_6b", "qwen2_1_5b", "gemma_2b", "gemma_7b"]


def _configs(arch, dtype="float32", **kw):
    """(repro config, port config) of an arch's SMOKE, equal field for
    field."""
    jcfg = j_get_smoke_config(arch).scaled(dtype=dtype, **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _noisy(tree, seed):
    """numpy copy of a params tree with seeded noise on every leaf."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _both(np_tree):
    return (jax.tree.map(jnp.asarray, np_tree),
            params_from_numpy(np_tree, device="cpu"))


def _close(got, want, tol=TOL, of_max=False):
    """Elementwise within `tol`, or with `of_max` within `tol` of the
    largest |want| (see the module docstring)."""
    got = got.float() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = tol * float(np.abs(want).max()) if of_max else tol
    assert_allclose(got, want, rtol=tol, atol=atol)


# -- configs and params -------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_repro(arch):
    for jget, tget in ((j_get_config, tconfigs.get_config),
                       (j_get_smoke_config, tconfigs.get_smoke_config)):
        jcfg, tcfg = jget(arch), tget(arch.replace("_", "-"))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tconfigs.get_config(arch).compute_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["musicgen_medium", "internvl2_76b"])
def test_unported_configs_refuse(arch):
    """The embeddings families are ported (their configs resolve and `LM`
    constructs); what still refuses them is `ServeEngine`, whose prompts
    are tokens, as `repro`'s are."""
    for jget, tget in ((j_get_config, tconfigs.get_config),
                       (j_get_smoke_config, tconfigs.get_smoke_config)):
        assert dataclasses.asdict(tget(arch)) == \
            dataclasses.asdict(jget(arch))
    cfg = tconfigs.get_smoke_config(arch)
    TLM(cfg)
    with pytest.raises(ValueError, match="LM.prefill"):
        TServeEngine(cfg, {}, batch=1, max_len=8, device="cpu")
    with pytest.raises(KeyError):
        tconfigs.get_config(arch + "_x")


@pytest.mark.parametrize("arch,tie", [(a, True) for a in DENSE]
                         + [("qwen2_1_5b", False)])
def test_init_gives_repro_tree(arch, tie):
    jcfg, tcfg = _configs(arch, tie_embeddings=tie)
    want = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    got = TLM(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(a.shape), str(a.dtype)) for p, a in _leaves(want)] \
        == [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _leaves(got)]
    jcache = JLM(jcfg).init_cache(2, 16)
    tcache = TLM(tcfg).init_cache(2, 16, device="cpu")
    assert tcache["len"] == int(jcache["len"]) == 0
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert tcache[name].dtype == torch.float32 and not tcache[name].any()


def test_params_from_numpy_carries_repro_params():
    jcfg, _ = _configs("qwen3_0_6b")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(1))
    got = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    pairs = list(zip(_leaves(jparams), _leaves(got)))
    assert len(pairs) == len(list(_leaves(jparams)))
    for (jp, ja), (tp, ta) in pairs:
        assert jp == tp and ta.dtype == torch.float32
        assert np.array_equal(ta.numpy(), np.asarray(ja))


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rmsnorm_and_rope_match_repro(dtype, tol):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    _close(tL.rmsnorm({"scale": torch.tensor(scale)}, tx, 1e-6),
           jL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6), tol)
    _close(tL.rope(tx, torch.tensor(pos), 1e6),
           jL.rope(jx, jnp.asarray(pos), 1e6), tol)
    _close(tL.rope(tx, torch.tensor(pos), 1e4),
           jL.rope(jx, jnp.asarray(pos), 1e4), tol)


def _attn_params(jcfg, seed):
    return _both(_noisy(jL.attention_init(jax.random.PRNGKey(seed), jcfg),
                        seed))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_1_5b", "gemma_2b"])
def test_qkv_and_attention_block_match_repro(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _attn_params(jcfg, 3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    for got, want in zip(
            tL._qkv(tp, torch.tensor(x), tcfg, torch.tensor(pos)),
            jL._qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))):
        _close(got, want)
    out, (k, v) = tL.attention_block(tp, torch.tensor(x), tcfg,
                                     torch.tensor(pos))
    jout, (jk, jv) = jL.attention_block(jp, jnp.asarray(x), jcfg,
                                        jnp.asarray(pos))
    for got, want in ((out, jout), (k, jk), (v, jv)):
        _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "gemma_2b"])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_attention_decode_matches_repro(arch, dtype, tol):
    jcfg, tcfg = _configs(arch, dtype=dtype)
    jp, tp = _attn_params(jcfg, 4)
    rng = np.random.default_rng(4)
    B, Smax, clen = 2, 16, 6
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Smax, jcfg.n_kv_heads, jcfg.head_dim))
              .astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tck, tcv = torch.tensor(ck).to(tdt), torch.tensor(cv).to(tdt)
    out, nk, nv = tL.attention_decode(tp, torch.tensor(x).to(tdt), tcfg,
                                      tck, tcv, clen)
    assert nk is tck and nv is tcv                  # written in place
    jout, jk, jv = jL.attention_decode(jp, jnp.asarray(x, jdt), jcfg,
                                       jnp.asarray(ck, jdt),
                                       jnp.asarray(cv, jdt), jnp.int32(clen))
    for got, want in ((out, jout), (nk, jk), (nv, jv)):
        _close(got, want, tol)


@pytest.mark.parametrize("arch,act", [("qwen3_0_6b", "swiglu"),
                                      ("gemma_2b", "geglu"),
                                      ("qwen3_0_6b", "gelu")])
def test_mlp_block_matches_repro(arch, act):
    jcfg, tcfg = _configs(arch, act=act)
    jp, tp = _both(_noisy(jL.mlp_init(jax.random.PRNGKey(5), jcfg), 5))
    assert sorted(tp) == (["wi", "wo"] if act == "gelu"
                          else ["wg", "wi", "wo"])
    x = np.random.default_rng(5).standard_normal(
        (2, 3, jcfg.d_model)).astype(np.float32)
    _close(tL.mlp_block(tp, torch.tensor(x), tcfg),
           jL.mlp_block(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_logits_head_match_repro(tie):
    jcfg, tcfg = _configs("qwen2_1_5b", tie_embeddings=tie)
    jp, tp = _both(_noisy(jL.embedding_init(jax.random.PRNGKey(6), jcfg), 6))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    _close(tL.embed(tp, torch.tensor(toks), tcfg),
           jL.embed(jp, jnp.asarray(toks), jcfg))
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    got = tL.logits_head(tp, torch.tensor(x), tcfg)
    assert got.dtype == torch.float32
    _close(got, jL.logits_head(jp, jnp.asarray(x), jcfg))


# -- the model --------------------------------------------------------------

def _models(arch, dtype="float32", seed=7, **kw):
    jcfg, tcfg = _configs(arch, dtype=dtype, **kw)
    jp, tp = _both(_noisy(JLM(jcfg).init(jax.random.PRNGKey(seed)), seed))
    return JLM(jcfg), jp, TLM(tcfg), tp


def _check_cache(tcache, jcache, tol, of_max):
    assert tcache["len"] == int(jcache["len"])
    _close(tcache["k"], jcache["k"], tol, of_max)
    _close(tcache["v"], jcache["v"], tol, of_max)


@pytest.mark.parametrize("arch,dtype,tol", [
    ("qwen3_0_6b", "float32", TOL), ("qwen2_1_5b", "float32", TOL),
    ("gemma_2b", "float32", TOL), ("qwen3_0_6b", "bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_repro(arch, dtype, tol):
    jlm, jp, tlm, tp = _models(arch, dtype)
    of_max = dtype == "bfloat16"
    rng = np.random.default_rng(8)
    vocab = jlm.cfg.vocab
    prompt = rng.integers(0, vocab, (2, 10)).astype(np.int32)
    nxt = rng.integers(0, vocab, (4, 2, 1)).astype(np.int32)
    max_len = 16
    tlog, tcache = tlm.prefill(tp, torch.tensor(prompt), max_len)
    jlog, jcache = jlm.prefill(jp, jnp.asarray(prompt), max_len)
    assert tuple(tlog.shape) == (2, 1, vocab) and tlog.dtype == torch.float32
    _close(tlog, jlog, tol, of_max)
    _check_cache(tcache, jcache, tol, of_max)
    for tok in nxt:
        tlog, tcache = tlm.decode_step(tp, tcache, torch.tensor(tok))
        jlog, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok))
        _close(tlog, jlog, tol, of_max)
        _check_cache(tcache, jcache, tol, of_max)


def test_forward_matches_repro():
    jlm, jp, tlm, tp = _models("qwen3_0_6b")
    toks = np.random.default_rng(9).integers(0, 512, (2, 9)).astype(np.int32)
    got, aux = tlm.forward(tp, torch.tensor(toks))
    want, _ = jlm.forward(jp, jnp.asarray(toks))
    assert aux == 0.0
    _close(got, want)


def test_prefill_then_decode_equals_longer_prefill():
    """Teacher forcing on the port alone: prefill S+1 tokens equals
    prefill S then one decode step, in logits and cache."""
    _, _, tlm, tp = _models("gemma_2b")
    toks = torch.tensor(np.random.default_rng(10).integers(
        0, 512, (3, 13)).astype(np.int32))
    long_logits, long_cache = tlm.prefill(tp, toks, 20)
    _, cache = tlm.prefill(tp, toks[:, :-1], 20)
    logits, cache = tlm.decode_step(tp, cache, toks[:, -1:])
    torch.testing.assert_close(logits, long_logits, rtol=TOL, atol=TOL)
    assert cache["len"] == long_cache["len"] == 13
    torch.testing.assert_close(cache["k"], long_cache["k"], rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(cache["v"], long_cache["v"], rtol=TOL,
                               atol=TOL)


# -- the engine -----------------------------------------------------------

def _requests(cls, prompts, budgets):
    return [cls(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]


def test_engine_matches_repro_with_midflight_refill():
    """An untied head gives varied greedy tokens (a tied one tends to echo
    the prompt's last token).  Budgets 2, 6, 3, 4 on two slots: slot 0
    frees after 2 tokens while slot 1 still decodes, so requests 2 and 3
    enter mid-flight."""
    jlm, jp, tlm, tp = _models("qwen2_1_5b", tie_embeddings=False)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 5, 2, 4)]
    budgets = [2, 6, 3, 4]
    jeng = JServeEngine(jlm.cfg, jp, batch=2, max_len=48)
    teng = TServeEngine(tlm.cfg, tp, batch=2, max_len=48, device="cpu")
    want = jeng.generate(_requests(JRequest, prompts, budgets))
    got = teng.generate(_requests(TRequest, prompts, budgets))
    assert got == want
    assert teng.stats == jeng.stats
    assert teng.stats["refills"] >= 2
    assert [len(got[i]) for i in range(4)] == budgets
    assert len({tuple(v) for v in got.values()}) > 1


def test_engine_without_a_card_refuses_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tcfg = _configs("qwen3_0_6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServeEngine(tcfg, {}, batch=1, max_len=8)


def test_serve_launcher_runs_on_cpu():
    from repro_torch.launch.serve import main
    results = main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--requests", "5", "--max-new", "3"])
    assert sorted(results) == list(range(5))
    assert all(len(v) == 3 for v in results.values())
