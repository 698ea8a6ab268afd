"""The port's moe, ssm and hybrid LM families on the CPU against `repro`.

For each SMOKE config of moonshot-v1-16b-a3b and qwen3-moe-235b-a22b
(moe), rwkv6-7b (ssm) and zamba2-2.7b (hybrid):
  * the config equals `repro`'s field for field;
  * `LM.init` gives `repro`'s tree (`jax.eval_shape`), `init_cache` its
    cache, and `params_from_numpy` carries `repro`'s params unchanged;
  * `forward`, `LM.loss` (nll + 0.01 aux) and every gradient against
    `jax.value_and_grad`;
  * `prefill` and 3 `decode_step`s, logits and every cache entry;
  * the same requests through both `ServeEngine`s give the same tokens
    and stats, refills included;
  * `Trainer`: resumed from `repro`'s step-2 checkpoint it ends where
    `repro`'s straight 4-step run ends.
Plus the moe family with `kv_quant` (prefill and decode against
`repro`'s int8 cache), and the hybrid's shared block: its gradient is
the sum over the groups that use it.

Params are `repro`'s init plus seeded numpy noise on every leaf.
Tolerance: fp32 rtol = atol = 1e-4 for values, 1e-3 of each leaf's
largest magnitude for gradients (the sums of many layers' terms).
"""
from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_debug_mesh
from repro.models.lm import LM as JLM
from repro.optim import optimizer as jopt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import optimizer as topt
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.train import trainer as ttrainer

TOL = 1e-4
GRAD_TOL = 1e-3
ARCHS = ["moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b", "rwkv6_7b",
         "zamba2_2_7b"]


def _configs(arch, **kw):
    jcfg = j_get_smoke_config(arch).scaled(dtype="float32", **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


@functools.lru_cache(maxsize=None)
def _j_init(jcfg):
    """`repro`'s init, jitted once per config (each seed reuses it)."""
    return jax.jit(JLM(jcfg).init)


def _models(arch, seed=0, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    np_params = _noisy(_j_init(jcfg)(jax.random.PRNGKey(seed)), seed)
    return (JLM(jcfg), jax.tree.map(jnp.asarray, np_params), TLM(tcfg),
            params_from_numpy(np_params, device="cpu"))


def _assert_tree_close(got, want, tol=TOL, of_max=False):
    """Every leaf of the port's tree against `repro`'s, in jax's leaf
    order; with `of_max` the atol is `tol` of the leaf's largest |want|."""
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        atol = tol * float(np.abs(b).max()) if of_max else tol
        assert_allclose(a.detach().float().numpy(), b, rtol=tol, atol=atol,
                        err_msg=path)


def _check_cache(tcache, jcache):
    assert tcache["len"] == int(jcache["len"])
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        if name != "len":
            assert tuple(tcache[name].shape) == jcache[name].shape, name
            assert_allclose(tcache[name].float(),
                            np.asarray(jcache[name], np.float32), rtol=TOL,
                            atol=TOL, err_msg=name)


# -- configs and params ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro(arch):
    for jget, tget in ((j_get_config, tconfigs.get_config),
                       (j_get_smoke_config, tconfigs.get_smoke_config)):
        jcfg, tcfg = jget(arch), tget(arch.replace("_", "-"))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.d_inner == jcfg.d_inner
        assert tcfg.subquadratic == jcfg.subquadratic


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_give_repros_trees(arch):
    jcfg, tcfg = _configs(arch)
    want = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    with torch.device("meta"):
        got = TLM(tcfg).init_tree(torch.Generator())
    assert [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tL.tree_paths(got)] == \
        [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
         for p, a in jax.tree_util.tree_flatten_with_path(want)[0]]
    jcache = JLM(jcfg).init_cache(2, 16)
    tcache = TLM(tcfg).init_cache(2, 16, device="cpu")
    assert sorted(tcache) == sorted(jcache) and tcache["len"] == 0
    for name in tcache:
        if name != "len":
            assert tuple(tcache[name].shape) == jcache[name].shape, name
            assert str(tcache[name].dtype).replace("torch.", "") == \
                str(jcache[name].dtype), name


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_repro_params(arch):
    jcfg, _ = _configs(arch)
    jparams = _j_init(jcfg)(jax.random.PRNGKey(1))
    got = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(jparams)[0]
    paths = tL.tree_paths(got)
    assert [p for p, _ in paths] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (_, t), (_, a) in zip(paths, ref):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(a))


# -- the model ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_repro(arch):
    jlm, jp, tlm, tp = _models(arch, 2)
    b = jpipe.TokenDataset(vocab=jlm.cfg.vocab, seq_len=24, global_batch=2,
                           seed=3).batch(0)
    inputs, labels = b["inputs"], b["labels"].copy()
    labels[0, :3] = -1
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, inputs, labels), has_aux=True))(jp)
    (tloss, taux), tgrads = tsteps.loss_and_grads(
        tlm, tp, torch.tensor(inputs), torch.tensor(labels))
    assert_allclose(tloss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert_allclose(taux["aux"].item(), float(jaux["aux"]), rtol=TOL,
                    atol=TOL)
    if jlm.cfg.n_experts:
        assert taux["aux"].item() > 0.0
    _assert_tree_close(tgrads, jgrads, GRAD_TOL, of_max=True)
    hid, _ = tlm.forward(tp, torch.tensor(inputs))
    jhid, _ = jlm.forward(jp, jnp.asarray(inputs))
    assert_allclose(hid.detach(), jhid, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_repro(arch):
    jlm, jp, tlm, tp = _models(arch, 4)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jlm.cfg.vocab, (2, 11)).astype(np.int32)
    tlog, tcache = tlm.prefill(tp, torch.tensor(prompt), 16)
    jlog, jcache = jlm.prefill(jp, jnp.asarray(prompt), 16)
    assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
    _check_cache(tcache, jcache)
    for tok in rng.integers(0, jlm.cfg.vocab, (3, 2, 1)).astype(np.int32):
        before = {k: v for k, v in tcache.items() if k != "len"}
        tlog, tcache = tlm.decode_step(tp, tcache, torch.tensor(tok))
        jlog, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok))
        assert all(tcache[k] is v for k, v in before.items())   # in place
        assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
        _check_cache(tcache, jcache)


def test_moe_with_kv_quant_matches_repro():
    jlm, jp, tlm, tp = _models("moonshot_v1_16b_a3b", 6, kv_quant=True)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jlm.cfg.vocab, (2, 9)).astype(np.int32)
    tlog, tcache = tlm.prefill(tp, torch.tensor(prompt), 12)
    jlog, jcache = jlm.prefill(jp, jnp.asarray(prompt), 12)
    assert tcache["k"].dtype == torch.int8
    assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
    for tok in rng.integers(0, jlm.cfg.vocab, (2, 2, 1)).astype(np.int32):
        tlog, tcache = tlm.decode_step(tp, tcache, torch.tensor(tok))
        jlog, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok))
        assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
    for name in ("k", "v"):   # codes 1 apart at most (a tie rounds either way)
        diff = (tcache[name].int() - torch.tensor(np.asarray(jcache[name]))
                .int()).abs()
        assert int(diff.max()) <= 1
        assert_allclose(tcache[name + "_scale"], jcache[name + "_scale"],
                        rtol=TOL, atol=TOL)


def test_hybrid_shared_block_gradient_sums_over_its_groups():
    """zamba2's SMOKE has two groups: the shared block's gradient is the
    sum of its two uses, so it differs from the gradient with one group's
    use cut (the model at 2 layers, one group)."""
    _, _, tlm, tp = _models("zamba2_2_7b", 7)
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, 512, (2, 12)).astype(np.int32))
    _, grads = tsteps.loss_and_grads(tlm, tp, toks, toks)
    one = TLM(tlm.cfg.scaled(n_layers=tlm.cfg.attn_every))
    tp1 = dict(tp, blocks=tL.tree_map(lambda a: a[:tlm.cfg.attn_every],
                                      tp["blocks"]))
    _, grads1 = tsteps.loss_and_grads(one, tp1, toks, toks)
    g, g1 = grads["shared_attn"]["attn"]["wq"], \
        grads1["shared_attn"]["attn"]["wq"]
    assert g.abs().max() > 0 and not torch.allclose(g, g1)


# -- the engine and the trainer -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_repro(arch):
    jlm, jp, tlm, tp = _models(arch, 8)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (4, 6, 3, 5)]
    budgets = [2, 6, 3, 4]     # slot 0 frees twice while slot 1 decodes

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]

    jeng = JServeEngine(jlm.cfg, jp, batch=2, max_len=32)
    teng = TServeEngine(tlm.cfg, tp, batch=2, max_len=32, device="cpu")
    want = jeng.generate(reqs(JRequest))
    assert teng.generate(reqs(TRequest)) == want
    assert teng.stats == jeng.stats and teng.stats["refills"] >= 2


_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_resumed_from_repros_step_2_matches_repros_run(arch,
                                                               tmp_path):
    # repro's Trainer takes one microbatch.
    jcfg, tcfg = _configs(arch, microbatch=1)
    kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2, seed=0)

    def tc(cls, d):
        return cls(total_steps=4, ckpt_dir=str(d), ckpt_every=2,
                   log_every=1, async_checkpoint=False)

    want = jtrainer.Trainer(jcfg, make_debug_mesh(), jpipe.TokenDataset(**kw),
                            jopt.AdamWConfig(**_OPT),
                            tc(jtrainer.TrainerConfig, tmp_path / "j")).run()
    shutil.copytree(tmp_path / "j" / "step_2", tmp_path / "t" / "step_2")
    (tmp_path / "t" / "LATEST").write_text("2")
    out = ttrainer.Trainer(tcfg, tpipe.TokenDataset(**kw),
                           topt.AdamWConfig(**_OPT),
                           tc(ttrainer.TrainerConfig, tmp_path / "t"),
                           device="cpu").run()
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert_allclose([h["loss"] for h in out["history"]],
                    [h["loss"] for h in want["history"][2:]], rtol=TOL,
                    atol=TOL)
    _assert_tree_close(out["params"], want["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_the_launchers_take_the_arch(arch, capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    name = arch.replace("_", "-")
    results = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new", "2"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 2 for v in results.values())
    out = ttrain.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "16",
                       "--global-batch", "4"])
    assert [h["step"] for h in out["history"]] == [2]
    assert np.isfinite(out["history"][0]["loss"])
    assert "step     2  loss" in capsys.readouterr().out
