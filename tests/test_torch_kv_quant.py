"""The port's int8 KV cache on the CPU against `repro`'s.

  * `kv_quantize` / `kv_dequantize` on seeded fp32 and bf16 inputs (with
    an all-zero head row and exact half-way ties): the same codes and
    the same scales.  Both sides divide by the same fp32 scale and round
    half to even, so codes could only differ at a tie of the quotient (a
    differing code must be 1 apart and sit at such a tie); none differs
    on these inputs.
  * `attention_decode_quant` against `repro`'s within 1e-4 (fp32),
    codes and scales written in place.
  * `LM` with `kv_quant` (the qwen3-0.6b and qwen2-1.5b SMOKE configs,
    2 layers, fp32): prefill plus 3 decode steps, logits within 1e-4,
    cache codes at most 1 apart (counted), scales within 1e-4.
  * `ServeEngine` on an int8 cache with a mid-flight refill: the same
    tokens and stats as `repro`'s engine, and every (re)prefill hands
    back an int8 cache.

Tolerance: 1e-4 (DESIGN.md Sec. 2.3), as `tests/test_torch_lm.py`.  The
scores run on the int8 codes as `repro`'s do (late scales), so apart
from a code that sits at a rounding tie the two sides compute the same
fp32 sums in other orders.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import _attn_params, _close, _configs, _models, _requests
from repro.models import layers as jL
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.models import layers as tL
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4


def _kv_input(seed, dtype):
    """(2, 9, 3, 16) values of varied scale per (position, head), one
    all-zero head row, and one row whose max-abs is 127 so that the
    quotients 2.5, -0.5, 3.5 are exact ties."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 9, 3, 16)) * rng.uniform(
        0.01, 5.0, (2, 9, 3, 1))
    a[0, 1, 2] = 0.0
    a[1, 4, 0] = 0.0
    a[1, 4, 0, :4] = (127.0, 2.5, -0.5, 3.5)
    return np.asarray(jnp.asarray(a.astype(np.float32), dtype)
                      .astype(jnp.float32))


def _codes_agree(got, want, quotient):
    """Codes equal, or 1 apart where the quotient is a tie (within one
    fp32 ulp of x.5).  Returns the count of differing codes."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    diff = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    frac = np.abs(quotient - np.floor(quotient) - 0.5)
    ties = frac <= 4 * np.finfo(np.float32).eps * np.maximum(
        1.0, np.abs(quotient))
    assert not (diff & ~ties).any(), "a code differs away from a tie"
    return int(diff.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quantize_matches_repro(dtype, seed):
    x = _kv_input(seed, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tq, ts = tL.kv_quantize(torch.tensor(x).to(tdt))
    jq, js = jL.kv_quantize(jnp.asarray(x, jdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == x.shape and tuple(ts.shape) == x.shape[:-1]
    assert np.array_equal(ts.numpy(), np.asarray(js))
    quotient = x / np.asarray(js)[..., None]
    assert _codes_agree(tq.numpy(), jq, quotient) == 0
    # The exact ties round half to even on both sides.
    assert tq[1, 4, 0, :4].tolist() == [127, 2, 0, 4]
    assert ts[0, 1, 2].item() == np.float32(1e-6) / np.float32(127.0)
    for out_dt in ("float32", "bfloat16"):
        got = tL.kv_dequantize(tq, ts, getattr(torch, out_dt))
        want = jL.kv_dequantize(jq, js, jnp.dtype(out_dt))
        assert got.dtype == getattr(torch, out_dt)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_1_5b", "gemma_2b"])
@pytest.mark.parametrize("S", [1, 3])
def test_attention_decode_quant_matches_repro(arch, S):
    jcfg, tcfg = _configs(arch, kv_quant=True)
    jp, tp = _attn_params(jcfg, 4)
    rng = np.random.default_rng(14)
    B, Smax, clen = 2, 16, 6
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, B, Smax, jcfg.n_kv_heads,
                              jcfg.head_dim)).astype(np.float32)
    (kq, ksc), (vq, vsc) = (jL.kv_quantize(jnp.asarray(a)) for a in kv)
    tck, tcv = (torch.tensor(np.asarray(a)) for a in (kq, vq))
    tks, tvs = (torch.tensor(np.asarray(a)) for a in (ksc, vsc))
    out = tL.attention_decode_quant(tp, torch.tensor(x), tcfg, tck, tcv,
                                    tks, tvs, clen)
    assert all(a is b for a, b in zip(out[1:], (tck, tcv, tks, tvs)))
    want = jL.attention_decode_quant(jp, jnp.asarray(x), jcfg, kq, vq, ksc,
                                     vsc, jnp.int32(clen))
    _close(out[0], want[0])
    for got, w in zip(out[1:3], want[1:3]):
        assert np.abs(got.numpy().astype(np.int32)
                      - np.asarray(w, np.int32)).max() <= 1
    for got, w in zip(out[3:], want[3:]):
        _close(got, w)


def test_init_cache_matches_repro():
    from repro.models.lm import LM as JLM
    from repro_torch.models.lm import LM as TLM
    jcfg, tcfg = _configs("qwen3_0_6b", kv_quant=True)
    want = JLM(jcfg).init_cache(3, 20)
    got = TLM(tcfg).init_cache(3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("k", "v", "k_scale", "v_scale"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    assert got["len"] == int(want["len"]) == 0


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_1_5b"])
def test_prefill_and_decode_match_repro(arch):
    jlm, jp, tlm, tp = _models(arch, kv_quant=True)
    rng = np.random.default_rng(15)
    vocab = jlm.cfg.vocab
    prompt = rng.integers(0, vocab, (2, 10)).astype(np.int32)
    nxt = rng.integers(0, vocab, (3, 2, 1)).astype(np.int32)
    max_len = 16
    tlog, tcache = tlm.prefill(tp, torch.tensor(prompt), max_len)
    jlog, jcache = jlm.prefill(jp, jnp.asarray(prompt), max_len)
    flips = 0
    for step in range(len(nxt) + 1):
        _close(tlog, jlog)
        assert tcache["len"] == int(jcache["len"])
        for k in ("k", "v"):
            assert tcache[k].dtype == torch.int8
            d = np.abs(tcache[k].numpy().astype(np.int32)
                       - np.asarray(jcache[k], np.int32))
            assert d.max() <= 1, f"step {step} {k}"
            flips += int((d > 0).sum())
        for k in ("k_scale", "v_scale"):
            _close(tcache[k], jcache[k])
        if step < len(nxt):
            tlog, tcache = tlm.decode_step(tp, tcache,
                                           torch.tensor(nxt[step]))
            jlog, jcache = jlm.decode_step(jp, jcache,
                                           jnp.asarray(nxt[step]))
    n = tcache["k"].numel() * 2
    assert flips <= n * 1e-3, f"{flips} of {n} codes differ"


def test_decode_writes_the_int8_cache_in_place():
    _, _, tlm, tp = _models("qwen3_0_6b", kv_quant=True)
    toks = torch.tensor(np.random.default_rng(16).integers(
        0, 512, (2, 7)).astype(np.int32))
    _, cache = tlm.prefill(tp, toks, 12)
    bufs = {k: cache[k] for k in ("k", "v", "k_scale", "v_scale")}
    _, cache2 = tlm.decode_step(tp, cache, toks[:, :1])
    assert cache2["len"] == 8
    for k, buf in bufs.items():
        assert cache2[k] is buf
        assert bool(buf[:, :, 7].any()) and not bool(buf[:, :, 8:].any())


def test_engine_matches_repro_with_midflight_refill_on_an_int8_cache():
    """As `test_torch_lm.py`'s engine test, on an int8 cache: budgets 2,
    6, 3, 4 on two slots, so requests 2 and 3 enter mid-flight and each
    refill re-prefills into a fresh int8 cache."""
    jlm, jp, tlm, tp = _models("qwen2_1_5b", tie_embeddings=False,
                               kv_quant=True)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 5, 2, 4)]
    budgets = [2, 6, 3, 4]
    jeng = JServeEngine(jlm.cfg, jp, batch=2, max_len=48)
    teng = TServeEngine(tlm.cfg, tp, batch=2, max_len=48, device="cpu")
    dtypes = []
    prefill = teng._prefill

    def watched(p, t):
        logits, cache = prefill(p, t)
        dtypes.append((cache["k"].dtype, cache["k_scale"].dtype))
        return logits, cache

    teng._prefill = watched
    want = jeng.generate(_requests(JRequest, prompts, budgets))
    got = teng.generate(_requests(TRequest, prompts, budgets))
    assert got == want
    assert teng.stats == jeng.stats
    assert teng.stats["refills"] >= 2
    assert dtypes == [(torch.int8, torch.float32)] * teng.stats["prefills"]
    assert [len(got[i]) for i in range(4)] == budgets


def test_int8_decode_stays_near_the_float_cache():
    """`tests/test_models_smoke.py::test_int8_kv_cache_decode` on the
    port: the first decode's softmax within 0.05 of the unquantized
    cache's prefill over the same tokens."""
    _, _, tlm, tp = _models("qwen2_1_5b", kv_quant=True)
    from repro_torch.models.lm import LM as TLM
    ref = TLM(tlm.cfg.scaled(kv_quant=False))
    toks = torch.tensor(np.random.default_rng(1).integers(
        1, 512, (2, 17)).astype(np.int32))
    ref_logits, _ = ref.prefill(tp, toks, 25)
    _, cache = tlm.prefill(tp, toks[:, :16], 25)
    assert cache["k"].dtype == torch.int8
    dec, _ = tlm.decode_step(tp, cache, toks[:, 16:])
    diff = (torch.softmax(dec[:, 0], -1)
            - torch.softmax(ref_logits[:, 0], -1)).abs().max()
    assert float(diff) < 0.05
