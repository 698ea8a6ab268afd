"""The graph form of the port's decode step, on the CPU against `repro`.

`serve/decode_graph.py` captures `LM.decode_step` once per cache-length
bucket in a CUDA graph; the step it captures is the graph form, whose
cache "len" is a 0-d int32 tensor (`repro`'s own type) and whose
attention reads the bucket cache[:, :extent] with the split kernel's
device length.  The graph itself needs the card (tests/test_torch_cuda.py);
what it records is checked here:
  * the graph-form `decode_step` at each step's bucket
    (`decode_graph.bucket`) against `repro`'s jitted-step function over
    6 steps that cross a bucket edge (prompt 60, extents 64 then 128),
    for dense (qwen3-0.6b, fp32 and bf16), moe (moonshot-v1-16b-a3b),
    ssm (rwkv6-7b), hybrid (zamba2-2.7b) and the int8 cache (qwen3 with
    `kv_quant`): logits and every cache entry after each step, the
    length advanced in place on the tensor; and against the int form;
  * the bucket rule: every live length 1..max_len maps to the smallest
    bucket that holds it, with at most ceil(log2(max_len / 64)) + 1
    buckets;
  * the plain device-length attention (`flash_attention_plain(length=)`)
    and the split form's arithmetic with a device length
    (`split_kv_plain(length=)`, whose splits past the live end are
    empty) against `repro`'s masked decode attention;
  * `ServeEngine` on the CPU stays eager (no graph).

SMOKE configs at 2 layers (zamba2: 4, two groups), params `repro`'s init
plus seeded noise.  Tolerance: 1e-4 in fp32 (`tests/test_torch_lm.py`'s;
the attention sums in another order than `repro`'s masked softmax), 5e-2
of each leaf's largest magnitude in bf16 (both sides round bf16 matmul
outputs at other places); int8 codes at most 1 apart (a tie of the fp32
quotient rounds either way).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as tlm_tests
import test_torch_lm_families as fam_tests
from conftest import assert_allclose
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import layers as jL
from repro.models.lm import LM as JLM
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import attention as A
from repro_torch.kernels import ops
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.serve.decode_graph import bucket, buckets
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4
BF16_TOL = 5e-2
PROMPT, STEPS, MAX_LEN = 62, 4, 160      # lengths 62..65: extents 64, 128

# (arch, dtype, config overrides)
FORMS = [("qwen3_0_6b", "float32", {}), ("qwen3_0_6b", "bfloat16", {}),
         ("qwen3_0_6b", "float32", {"kv_quant": True}),
         ("moonshot_v1_16b_a3b", "float32", {}), ("rwkv6_7b", "float32", {}),
         ("zamba2_2_7b", "float32", {})]


def _models(arch, dtype, kw):
    """(repro's LM, its params, the port's LM, its params, repro's jitted
    prefill and decode step): `repro`'s init (jitted, shared with
    tests/test_torch_lm_families.py) plus seeded noise."""
    jcfg = j_get_smoke_config(arch).scaled(dtype=dtype, **kw)
    np_params = fam_tests._noisy(fam_tests._j_init(jcfg)(
        jax.random.PRNGKey(21)), 21)
    jlm = JLM(jcfg)
    return (jlm, jax.tree.map(jnp.asarray, np_params),
            TLM(TModelConfig(**dataclasses.asdict(jcfg))),
            params_from_numpy(np_params, device="cpu"),
            jax.jit(functools.partial(jlm.prefill, max_len=MAX_LEN)),
            jax.jit(jlm.decode_step))


def _device_len(cache):
    return dict(cache, len=torch.tensor(cache["len"], dtype=torch.int32))


def _hold(got, want, name, tol, of_max):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    atol = tol * float(np.abs(want).max()) if of_max else tol
    assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


@pytest.mark.parametrize("arch,dtype,kw", FORMS,
                         ids=[f"{a}-{d}" + ("-int8" if k else "")
                              for a, d, k in FORMS])
def test_graph_form_decode_matches_repro_and_the_int_form(arch, dtype, kw):
    jlm, jp, tlm, tp, jprefill, jdecode = _models(arch, dtype, kw)
    cfg = tlm.cfg
    of_max = dtype == "bfloat16"
    tol = BF16_TOL if of_max else TOL
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    _, tcache = tlm.prefill(tp, torch.tensor(prompt), MAX_LEN)
    _, icache = tlm.prefill(tp, torch.tensor(prompt), MAX_LEN)
    _, jcache = jprefill(jp, jnp.asarray(prompt))
    tcache = _device_len(tcache)
    length = tcache["len"]
    extents = []
    for tok in rng.integers(0, cfg.vocab, (STEPS, 2, 1)).astype(np.int32):
        n = int(length)
        extent = bucket(n + 1, MAX_LEN)
        extents.append(extent)
        tlog, tcache = tlm.decode_step(tp, tcache, torch.tensor(tok),
                                       extent=extent)
        ilog, icache = tlm.decode_step(tp, icache, torch.tensor(tok))
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        assert tcache["len"] is length and int(length) == n + 1 \
            == int(jcache["len"])            # advanced in place
        _hold(tlog, jlog, "logits", tol, of_max)
        _hold(tlog, ilog.numpy(), "logits vs the int form", tol, of_max)
        for name in sorted(k for k in tcache if k != "len"):
            if tcache[name].dtype == torch.int8:   # codes: a tie may flip
                diff = (tcache[name].int() - torch.tensor(
                    np.asarray(jcache[name])).int()).abs()
                assert int(diff.max()) <= 1, name
                assert torch.equal(tcache[name], icache[name]) or int(
                    (tcache[name].int() - icache[name].int()).abs().max()
                ) <= 1, name
            else:
                _hold(tcache[name], jcache[name], name, tol, of_max)
    assert extents[0] == 64 and extents[-1] == 128   # crossed the edge


@pytest.mark.parametrize("max_len", [32, 64, 160, 1280, 2048])
def test_bucket_rule(max_len):
    edges = buckets(max_len)
    assert edges[-1] == max_len and list(edges) == sorted(set(edges))
    assert len(edges) <= max(0, math.ceil(math.log2(max_len / 64))) + 1
    for live in range(1, max_len + 1):
        e = bucket(live, max_len)
        assert e >= live and e in edges
        assert all(f < live for f in edges if f < e)   # the smallest
    with pytest.raises(ValueError):
        bucket(max_len + 1, max_len)
    with pytest.raises(ValueError):
        bucket(0, max_len)
    if max_len == 2048:
        assert edges == (64, 128, 256, 512, 1024, 2048)


# (extent, cache length): a bucket's first and last positions, its
# middle, and lengths that leave whole splits empty (extent 1024 takes
# 8 splits at B 2, Hk 2: a length under 64 keys fills one).
LENGTHS = [(64, 0), (64, 63), (256, 130), (256, 255), (1024, 3),
           (1024, 100), (1024, 1023)]


@pytest.mark.parametrize("extent,n", LENGTHS)
def test_device_length_attention_matches_repros_masked_decode(extent, n):
    """q (2, 1, 8, 32) at position n over a (2, extent, 2, 32) bucket view
    whose keys past n are noise: the plain device-length attention and
    the split combine's emulation at `plan`'s split count for the extent
    (empty splits included) against `repro`'s masked softmax decode
    (`attention_decode`'s arithmetic) over the same view."""
    rng = np.random.default_rng(extent + n)
    B, Hq, Hk, D = 2, 8, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, Hq, D), (B, extent, Hk, D),
                         (B, extent, Hk, D)))
    g = Hq // Hk
    qf = (q * D ** -0.5).reshape(B, 1, Hk, g, D)
    s = jnp.einsum("bqhgd,bkhd->bqhgk", qf, k,
                   preferred_element_type=jnp.float32)
    s = jnp.where((jnp.arange(extent) <= n)[None, None, None, None, :], s,
                  -1e30)
    want = np.asarray(jnp.einsum("bqhgk,bkhd->bqhgd",
                                 jax.nn.softmax(s, axis=-1), v,
                                 preferred_element_type=jnp.float32)
                      ).reshape(B, 1, Hq, D)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    length = torch.tensor(n, dtype=torch.int32)
    form = A.plan(torch.float32, B, 1, extent, Hq, Hk, D)
    assert form.form == "split"
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(tq, tk, tv, causal=True, length=length)
    assert ops.LAUNCHES == before            # the CPU counts nothing
    emu = A.split_kv_plain(tq, tk, tv, splits=form.splits, length=n)
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_allclose(emu, want, rtol=TOL, atol=TOL)


def test_device_length_against_repros_decode_layer():
    """`layers.attention_decode_len` (int8 cache too) against `repro`'s
    `attention_decode` / `attention_decode_quant` at a length whose
    bucket leaves splits empty: output and the cache written in place."""
    jcfg, tcfg = tlm_tests._configs("qwen3_0_6b")
    jp, tp = tlm_tests._both(tlm_tests._noisy(jax.jit(
        jL.attention_init, static_argnums=1)(jax.random.PRNGKey(23), jcfg),
        23))
    rng = np.random.default_rng(23)
    B, Smax, n = 2, 256, 70
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Smax, tcfg.n_kv_heads,
                                   tcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    length = torch.tensor(n, dtype=torch.int32)
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    got = tL.attention_decode_len(tp, torch.tensor(x), tcfg, tk, tv, length,
                                  128)
    want, wk, wv = jax.jit(jL.attention_decode, static_argnums=2)(
        jp, jnp.asarray(x), jcfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(n))
    assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_allclose(tk, wk, rtol=TOL, atol=TOL)
    assert_allclose(tv, wv, rtol=TOL, atol=TOL)
    assert int(length) == n                  # the layer does not advance it
    codes = [tL.kv_quantize(torch.tensor(c)) for c in (ck, cv)]
    tq = [t.clone() for pair in codes for t in pair]
    got = tL.attention_decode_len(tp, torch.tensor(x), tcfg, tq[0], tq[2],
                                  length, 128, scales=(tq[1], tq[3]))
    want = jax.jit(jL.attention_decode_quant, static_argnums=2)(
        jp, jnp.asarray(x), jcfg, *(jnp.asarray(t.numpy())
                                    for t in (codes[0][0], codes[1][0],
                                              codes[0][1], codes[1][1])),
        jnp.int32(n))
    assert_allclose(got, want[0], rtol=TOL, atol=TOL)
    assert int((tq[0].int() - torch.tensor(np.asarray(want[1])).int())
               .abs().max()) <= 1
    assert_allclose(tq[1], want[3], rtol=TOL, atol=TOL)


def test_device_length_refusals():
    q = torch.zeros(2, 1, 4, 16)
    kv = torch.zeros(2, 64, 2, 16)
    n = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="0-d int32"):
        ops.flash_attention(q, kv, kv, length=n.long())
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, kv, kv, length=n, q_offset=3)
    with pytest.raises(ValueError, match="split form"):
        ops.flash_attention(torch.zeros(2, 64, 4, 16), kv, kv, length=n)
    _, tcfg = tlm_tests._configs("qwen3_0_6b")
    with pytest.raises(ValueError, match="extent"):
        tL.attention_decode_len({}, torch.zeros(1, 1, tcfg.d_model), tcfg,
                                torch.zeros(1, 32, 2, 16),
                                torch.zeros(1, 32, 2, 16), n, 64)


def test_engine_on_the_cpu_stays_eager():
    _, tcfg = tlm_tests._configs("qwen3_0_6b")
    assert TServeEngine(tcfg, {}, batch=1, max_len=8,
                        device="cpu").graph is None
