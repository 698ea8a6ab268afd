"""The port's LM training slice on the CPU against `repro`.

  * `chunked_xent` (labels of -1 masked, a ragged last chunk, tied and
    untied heads): value and gradients against `repro`'s.
  * `LM.loss` and every gradient of qwen3-0.6b's SMOKE config (remat
    "full": each layer under `torch.utils.checkpoint`, the attention
    through `FlashAttentionFn`) against `jax.value_and_grad`; remat
    "none" gives the same gradients.
  * `make_train_step` at n_micro 1 and 2: one AdamW step -- params,
    optimizer state and metrics -- against `repro`'s jitted step.
  * `TokenDataset` bit-identical to `repro`'s, synthetic, with
    embeddings, and from a token file; `Prefetcher`'s order and failure.
  * `Trainer`: resumed from `repro`'s step-2 checkpoint it ends where
    `repro`'s straight 4-step run ends, and `repro` restores its final
    checkpoint; its own resume after a failure is bit-equal to its
    straight run.
  * The launcher and the example on `--device cpu --smoke`.

All in fp32 (the SMOKE config at dtype float32), rtol = atol = 1e-4: the
two frameworks sum in other orders.  Params are `repro`'s init plus
seeded numpy noise on every leaf, so norm scales are not zero.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch.mesh import make_debug_mesh
from repro.models import layers as jL
from repro.models.lm import LM as JLM
from repro.optim import optimizer as jopt
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.examples import train_lm as tex
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer

TOL = 1e-4
ARCH = "qwen3_0_6b"


def _configs(**kw):
    """(repro config, port config) of the SMOKE config in fp32, equal
    field for field."""
    jcfg = j_get_smoke_config(ARCH).scaled(dtype="float32", **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _assert_tree_close(got, want, tol=TOL):
    """Every leaf of the port's tree against `repro`'s, path by path in
    jax's leaf order."""
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert_allclose(a.detach().float().numpy(),
                        np.asarray(jnp.asarray(b, jnp.float32)), rtol=tol,
                        atol=tol, err_msg=path)


def _batch(cfg, seq_len, batch, seed=3, step=0, masked=True):
    """A TokenDataset batch with some labels set to -1."""
    b = jpipe.TokenDataset(vocab=cfg.vocab, seq_len=seq_len,
                           global_batch=batch, seed=seed).batch(step)
    labels = b["labels"].copy()
    if masked:
        labels[0, :5] = -1
        labels[-1, -3:] = -1
    return b["inputs"], labels


# -- chunked cross-entropy ----------------------------------------------------

@pytest.mark.parametrize("tied", [True, False])
def test_chunked_xent_matches_repro(tied):
    jcfg, tcfg = _configs(tie_embeddings=tied, loss_chunk=16)
    rng = np.random.default_rng(7)
    emb = {"tok": rng.standard_normal((jcfg.vocab, jcfg.d_model))
           .astype(np.float32)}
    if not tied:
        emb["head"] = (rng.standard_normal((jcfg.d_model, jcfg.vocab))
                       / 8).astype(np.float32)
    x = (rng.standard_normal((2, 45, jcfg.d_model)) / 8).astype(np.float32)
    _, labels = _batch(jcfg, 45, 2)
    jval, (jge, jgx) = jax.jit(jax.value_and_grad(
        lambda p, a: jL.chunked_xent(p, a, labels, jcfg), argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, emb), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in emb.items()}
    tx = torch.tensor(x, requires_grad=True)
    tval = tL.chunked_xent(tp, tx, torch.tensor(labels), tcfg)
    tval.backward()
    assert tval.dtype == torch.float32 and tval.dim() == 0
    assert_allclose(tval.item(), float(jval), rtol=TOL, atol=TOL)
    assert_allclose(tx.grad, np.asarray(jgx), rtol=TOL, atol=TOL)
    for k in emb:
        if not tied and k == "tok":   # the untied head reads no embedding
            assert tp[k].grad is None and not np.asarray(jge[k]).any()
            continue
        assert_allclose(tp[k].grad, np.asarray(jge[k]), rtol=TOL, atol=TOL)


# -- LM.loss and its gradients ------------------------------------------------

def test_lm_loss_and_every_gradient_match_repro():
    jcfg, tcfg = _configs()
    np_params = _noisy(JLM(jcfg).init(jax.random.PRNGKey(0)), 1)
    inputs, labels = _batch(jcfg, 40, 2)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JLM(jcfg).loss(p, inputs, labels), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params))
    tparams = params_from_numpy(np_params, device="cpu")
    lm = TLM(tcfg)
    (tloss, taux), tgrads = tsteps.loss_and_grads(
        lm, tparams, torch.tensor(inputs), torch.tensor(labels))
    assert_allclose(tloss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert_allclose(taux["nll"].item(), float(jaux["nll"]), rtol=TOL,
                    atol=TOL)
    _assert_tree_close(tgrads, jgrads)
    # Without remat: the same gradients.
    (nloss, _), ngrads = tsteps.loss_and_grads(
        TLM(tcfg.scaled(remat="none")), tparams, torch.tensor(inputs),
        torch.tensor(labels))
    assert_allclose(nloss.item(), tloss.item(), rtol=1e-6, atol=1e-6)
    for a, b in zip(tL.tree_leaves(ngrads), tL.tree_leaves(tgrads)):
        assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_repro(n_micro):
    """AdamW's first step moves each weight by lr * g / (|g| + eps), g
    the clipped gradient.  Where |g| is near the default eps of 1e-8 the
    fraction of lr is decided by rounding: at n_micro = 2 one entry of
    mlp.wi has a raw gradient of 2e-7 that cancels from terms of ~0.03,
    the two sides round it 60 % apart, and after clipping by 1/17 its
    step differs by 0.1 lr.  eps = 1e-6 keeps the comparison off that
    edge."""
    jcfg, tcfg = _configs()
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=10, eps=1e-6)
    jo, to = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    np_params = _noisy(JLM(jcfg).init(jax.random.PRNGKey(1)), 2)
    inputs, labels = _batch(jcfg, 24, 4, seed=5)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, n_micro))
    jp2, jstate, jm = jstep(jp, jopt.adamw_init(jp, jo),
                            {"inputs": inputs, "labels": labels})
    tp = params_from_numpy(np_params, device="cpu")
    tstep = tsteps.make_train_step(tcfg, to, n_micro)
    tp2, tstate, tm = tstep(tp, topt.adamw_init(tp, to),
                            {"inputs": torch.tensor(inputs),
                             "labels": torch.tensor(labels)})
    for key in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert_allclose(tm[key].item(), float(jm[key]), rtol=TOL, atol=TOL,
                        err_msg=key)
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(tstate, jstate)
    assert tsteps.effective_microbatches(tcfg, 8) == 4
    assert tsteps.effective_microbatches(tcfg, 6) == 3
    assert tsteps.effective_microbatches(tcfg.scaled(microbatch=1), 8) == 1


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic", "embed", "file"])
def test_token_dataset_is_repros_bit_for_bit(kind, tmp_path):
    kw = dict(vocab=1000, seq_len=17, global_batch=3, seed=11)
    if kind == "embed":
        kw["embed_dim"] = 8
    if kind == "file":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 1000, 5000).astype(
            np.uint32).tofile(path)
        kw["token_file"] = str(path)
    jds, tds = jpipe.TokenDataset(**kw), tpipe.TokenDataset(**kw)
    for step in (0, 1, 7):
        want, got = jds.batch(step), tds.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (step, k)
    it = tds.iterate(5)
    assert np.array_equal(next(it)["inputs"], jds.batch(5)["inputs"])


def test_prefetcher_yields_in_step_order_and_surfaces_failures():
    ds = tpipe.TokenDataset(vocab=50, seq_len=5, global_batch=2, seed=1)
    pf = tpipe.Prefetcher(ds, start_step=3, depth=2,
                          put=lambda b: {k: v + 1 for k, v in b.items()})
    for step in range(3, 9):
        got = next(pf)
        assert np.array_equal(got["inputs"], ds.batch(step)["inputs"] + 1)
    pf.close()
    assert not pf._t.is_alive()

    calls = []

    def put(b):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("copy failed")
        return b

    pf = tpipe.Prefetcher(ds, put=put)
    assert np.array_equal(next(pf)["labels"], ds.batch(0)["labels"])
    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        next(pf)
    pf.close()


# -- the trainer --------------------------------------------------------------

_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=4)


def _tcfg(cls, ckpt_dir, **kw):
    return cls(total_steps=4, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=1,
               async_checkpoint=False, **kw)


def _port_trainer(ckpt_dir, **kw):
    # repro's Trainer ignores the config's microbatch and takes one.
    _, tcfg = _configs(microbatch=1)
    ds = tpipe.TokenDataset(vocab=tcfg.vocab, seq_len=32, global_batch=4,
                            seed=0)
    return ttrainer.Trainer(tcfg, ds, topt.AdamWConfig(**_OPT),
                            _tcfg(ttrainer.TrainerConfig, ckpt_dir, **kw),
                            device="cpu")


def test_trainer_resumed_from_repros_step_2_matches_repros_run(tmp_path):
    jcfg, _ = _configs()
    jd = tmp_path / "repro"
    ds = jpipe.TokenDataset(vocab=jcfg.vocab, seq_len=32, global_batch=4,
                            seed=0)
    want = jtrainer.Trainer(jcfg, make_debug_mesh(), ds,
                            jopt.AdamWConfig(**_OPT),
                            _tcfg(jtrainer.TrainerConfig, str(jd))).run()
    d = tmp_path / "port"
    shutil.copytree(jd / "step_2", d / "step_2")
    (d / "LATEST").write_text("2")
    out = _port_trainer(str(d)).run()
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert_allclose([h["loss"] for h in out["history"]],
                    [h["loss"] for h in want["history"][2:]], rtol=TOL,
                    atol=TOL)
    _assert_tree_close(out["params"], want["params"])
    _assert_tree_close(out["opt"], want["opt"])
    # repro restores the port's final checkpoint, leaf for leaf.
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        {"params": want["params"], "opt": want["opt"]})
    back = jckpt.restore(str(d), 4, like)
    for (_, a), b in zip(tL.tree_paths({"params": out["params"],
                                        "opt": out["opt"]}),
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_trainer_resume_is_bit_equal_to_the_straight_run(tmp_path):
    ref = _port_trainer(str(tmp_path / "a")).run()
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _port_trainer(str(tmp_path / "b")).run(fail_at_step=3)
    out = _port_trainer(str(tmp_path / "b")).run()
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][2:]]
    for a, b in zip(tL.tree_leaves({"p": out["params"], "o": out["opt"]}),
                    tL.tree_leaves({"p": ref["params"], "o": ref["opt"]})):
        assert torch.equal(a, b)


def test_trainer_takes_the_configs_microbatches():
    _, tcfg = _configs()
    ds = tpipe.TokenDataset(vocab=tcfg.vocab, seq_len=8, global_batch=8)
    assert ttrainer.Trainer(tcfg, ds, device="cpu").n_micro == 4
    assert ttrainer.Trainer(tcfg.scaled(microbatch=3), ds,
                            device="cpu").n_micro == 2


# -- entry points -------------------------------------------------------------

def test_the_launcher_trains_on_the_cpu(capsys):
    out = tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--seq-len", "32",
                        "--global-batch", "4"])
    assert [h["step"] for h in out["history"]] == [3]
    assert np.isfinite(out["history"][0]["loss"])
    assert "step     3  loss" in capsys.readouterr().out


def test_the_example_resumes_across_a_failure_and_the_loss_falls(capsys):
    out = tex.main(["--device", "cpu", "--steps", "20"])
    text = capsys.readouterr().out
    assert "injected failure at step 10" in text
    assert [h["step"] for h in out["history"]] == [15, 20]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
