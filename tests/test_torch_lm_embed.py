"""The port's audio and vlm LM families on the CPU against `repro`.

musicgen-medium (audio) and internvl2-76b (vlm) take (B, S, D)
embeddings in place of tokens (`embed_input`: the stub frontends'
frames and patches) and decode on tokens through their untied `tok`
table.  For each SMOKE config:
  * `CONFIG` and `SMOKE` equal `repro`'s field for field, and
    `supported_shapes` equals `repro`'s for all ten ids;
  * `LM.init` gives `repro`'s tree (`tok` and `head`);
  * `forward`, `LM.loss` and every gradient against `jax.value_and_grad`
    on the same numpy params and embeddings, in fp32 and in bf16 (the
    token table, read only by decode, gets zeros on both sides);
  * `prefill` on embeddings, then `decode_step`s on tokens: logits per
    call and the cache;
  * `make_train_step` at n_micro 1 and 2: one AdamW step;
  * `launch.train --smoke --device cpu` for 2 steps;
  * `ServeEngine` refuses the config (its prompts are tokens).

Tolerance: fp32 rtol = atol = 1e-4 for values, 1e-3 of each leaf's
largest magnitude for gradients; bf16 5e-2 of each leaf's (each
output's) largest magnitude.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.lm import LM as JLM
from repro.optim import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import optimizer as topt
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4
GRAD_TOL = 1e-3
BF16_TOL = 5e-2
ARCHS = ["musicgen_medium", "internvl2_76b"]


def _configs(arch, dtype="float32", **kw):
    jcfg = jconfigs.get_smoke_config(arch).scaled(dtype=dtype, **kw)
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
    """`repro`'s init, jitted once per config."""
    return jax.jit(JLM(jcfg).init)


def _models(arch, seed=0, dtype="float32", **kw):
    jcfg, tcfg = _configs(arch, dtype, **kw)
    np_params = _noisy(_j_init(_configs(arch, **kw)[0])(
        jax.random.PRNGKey(seed)), seed)
    return (JLM(jcfg), jax.tree.map(jnp.asarray, np_params), TLM(tcfg),
            params_from_numpy(np_params, device="cpu"))


def _frames(cfg, batch, seq, seed):
    """Seeded (B, S, D) fp32 embeddings and next-token labels, some
    masked."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels[0, :3] = -1
    return x, labels


def _j_precast(params, cfg):
    """`repro`'s train-step cast: fp32 leaves of ndim >= 2 to the compute
    dtype (the port's `steps.precast`)."""
    return jax.tree.map(lambda a: a.astype(cfg.compute_dtype)
                        if a.ndim >= 2 and a.dtype == jnp.float32 else a,
                        params)


def _assert_tree_close(got, want, tol=TOL, of_max=False):
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        atol = tol * float(np.abs(b).max()) if of_max else tol
        assert_allclose(a.detach().float().numpy(), b, rtol=tol, atol=atol,
                        err_msg=path)


def _close(got, want, tol, of_max):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol = tol * float(np.abs(want).max()) if of_max else tol
    assert_allclose(got.detach().float(), want, rtol=tol, atol=atol)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro(arch):
    for jget, tget in ((jconfigs.get_config, tconfigs.get_config),
                       (jconfigs.get_smoke_config,
                        tconfigs.get_smoke_config)):
        jcfg, tcfg = jget(arch), tget(arch.replace("_", "-"))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.embed_input and not tcfg.tie_embeddings
    assert tconfigs.get_config(arch).compute_dtype == torch.bfloat16
    TLM(tconfigs.get_config(arch))     # the full config constructs


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_supported_shapes_equal_repro(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.supported_shapes(tconfigs.get_config(arch)) == \
        jconfigs.supported_shapes(jconfigs.get_config(arch))
    assert sorted(tconfigs.SHAPES) == sorted(jconfigs.SHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_gives_repros_tree(arch):
    jcfg, tcfg = _configs(arch)
    want = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    got = TLM(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tL.tree_paths(got)] == \
        [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
         for p, a in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert sorted(got["embed"]) == ["head", "tok"]


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", GRAD_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_repro(arch, dtype, tol):
    jlm, jp, tlm, tp = _models(arch, 2, dtype)
    x, labels = _frames(jlm.cfg, 2, 24, 3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(_j_precast(p, jlm.cfg), x, labels),
        has_aux=True))(jp)
    (tloss, _), tgrads = tsteps.loss_and_grads(
        tlm, tp, torch.tensor(x), torch.tensor(labels))
    of_max = dtype == "bfloat16"
    assert_allclose(tloss.item(), float(jloss), rtol=tol if of_max else TOL,
                    atol=tol if of_max else TOL)
    assert float(tgrads["embed"]["tok"].abs().max()) == 0.0
    _assert_tree_close(tgrads, jgrads, tol, of_max=True)
    hid, _ = tlm.forward(tp, torch.tensor(x))
    jhid, _ = jlm.forward(jp, jnp.asarray(x))
    assert hid.dtype == tlm.cfg.compute_dtype
    _close(hid, jhid, BF16_TOL if of_max else TOL, of_max)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_embeddings_then_decode_on_tokens_match_repro(arch):
    jlm, jp, tlm, tp = _models(arch, 4)
    x, _ = _frames(jlm.cfg, 2, 11, 5)
    tlog, tcache = tlm.prefill(tp, torch.tensor(x), 16)
    jlog, jcache = jlm.prefill(jp, jnp.asarray(x), 16)
    assert tuple(tlog.shape) == (2, 1, jlm.cfg.vocab)
    assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
    rng = np.random.default_rng(6)
    for tok in rng.integers(0, jlm.cfg.vocab, (3, 2, 1)).astype(np.int32):
        tlog, tcache = tlm.decode_step(tp, tcache, torch.tensor(tok))
        jlog, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok))
        assert_allclose(tlog, jlog, rtol=TOL, atol=TOL)
    assert tcache["len"] == int(jcache["len"]) == 14
    for name in ("k", "v"):
        assert_allclose(tcache[name], np.asarray(jcache[name]), rtol=TOL,
                        atol=TOL, err_msg=name)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_repro(arch, n_micro):
    """One AdamW step on embeddings (eps 1e-6, as
    `test_torch_lm_train.py` takes it, off the rounding edge of tiny
    gradients)."""
    jlm, jp, tlm, tp = _models(arch, 1)
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=10, eps=1e-6)
    jo, to = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    x, labels = _frames(jlm.cfg, 4, 16, 7)
    jp2, jstate, jm = jax.jit(jsteps.make_train_step(jlm.cfg, jo, n_micro))(
        jp, jopt.adamw_init(jp, jo), {"inputs": x, "labels": labels})
    tp2, tstate, tm = tsteps.make_train_step(tlm.cfg, to, n_micro)(
        tp, topt.adamw_init(tp, to),
        {"inputs": torch.tensor(x), "labels": torch.tensor(labels)})
    for key in ("loss", "nll", "grad_norm", "lr"):
        assert_allclose(tm[key].item(), float(jm[key]), rtol=TOL, atol=TOL,
                        err_msg=key)
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(tstate, jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_launcher_trains_on_embeddings(arch, capsys):
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", arch.replace("_", "-"), "--smoke",
                       "--device", "cpu", "--steps", "2", "--seq-len", "16",
                       "--global-batch", "4"])
    assert [h["step"] for h in out["history"]] == [2]
    assert np.isfinite(out["history"][0]["loss"])
    assert "step     2  loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_embedding_inputs(arch):
    cfg = tconfigs.get_smoke_config(arch)
    with pytest.raises(ValueError, match="embeddings"):
        TServeEngine(cfg, {}, batch=2, max_len=16, device="cpu")
