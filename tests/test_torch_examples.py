"""The port's example programs (`repro_torch/examples/`) on the CPU against
`repro`'s (`examples/`, loaded with importlib: not a package).

`segment_atrous`: the synthetic batches are `repro`'s bit for bit; three
training steps (the atrous loss's gradients, AdamW, the post-update
logits' pixel accuracy) at batch 2, 24x24 on the port's `cuda` backend
(the kernels' plain versions on CPU tensors) equal `repro`'s example step
on `xla_zero_free` within 1e-4: losses, accuracies, every param and the
optimizer state.

`train_cnn_ecoflow` and `train_gan`: their synthetic batches (and the
GAN's latents) are `repro`'s bit for bit; three steps of each at the
examples' own sizes on the `cuda` backend equal `repro`'s example step
on `xla_zero_free` within 1e-4 (losses, the CNN's accuracy, every param
and both AdamW states).  `serve_lm`: its requests are `repro`'s draw bit
for bit, and on the same fp32 params its greedy tokens are `repro`'s
engine's.  Each CLI runs on the CPU."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.models import vision as jvision
from repro.optim import optimizer as jopt
from repro.models import cnn as jcnn
from repro.models import gan as jgan
from repro_torch.convert import params_from_numpy
from repro_torch.examples import segment_atrous as tex
from repro_torch.examples import serve_lm as tserve
from repro_torch.examples import train_cnn_ecoflow as tcnn_ex
from repro_torch.examples import train_gan as tgan_ex
from repro_torch.models.layers import tree_paths
from repro_torch.optim import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _repro_example(name):
    spec = importlib.util.spec_from_file_location(
        f"repro_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("step,batch,size", [(0, 2, 24), (2, 2, 24),
                                             (5, 8, 24), (1, 16, 128)])
def test_synth_batch_is_repros_bit_for_bit(step, batch, size):
    jx, jy = _repro_example("segment_atrous").synth_batch(
        step, batch=batch, size=size)
    tx, ty = tex.synth_batch(step, batch=batch, size=size)
    assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("fuse", [True, False])
def test_segment_atrous_steps_match_repro(fuse):
    jex = _repro_example("segment_atrous")
    rates = tex.RATES
    jparams = jvision.atrous_head_init(
        jax.random.PRNGKey(0), in_ch=3, width=16, n_classes=2, rates=rates)
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=3, weight_decay=0.01)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstate = jopt.adamw_init(jparams, jcfg)

    @jax.jit
    def jstep(params, opt, x, y):        # examples/segment_atrous.py:67-78
        loss, grads = jax.value_and_grad(
            lambda p: jvision.atrous_seg_loss(
                p, x, y, rates=rates, backend="xla_zero_free",
                fuse_epilogue=fuse))(params)
        params, opt, _ = jopt.adamw_update(grads, opt, params, jcfg)
        logits = jvision.atrous_head_apply(
            params, x, rates=rates, backend="xla_zero_free",
            fuse_epilogue=fuse)
        return params, opt, loss, jnp.mean(jnp.argmax(logits, -1) == y)

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tstate = topt.adamw_init(tparams, tcfg)
    tstep = tex.make_step(tcfg, backend="cuda", fuse_epilogue=fuse)
    for step in range(3):
        x, y = jex.synth_batch(step, batch=2, size=24)
        jparams, jstate, jloss, jacc = jstep(jparams, jstate, x, y)
        tx, ty = tex.synth_batch(step, batch=2, size=24)
        tparams, tstate, tloss, tacc = tstep(tparams, tstate, tx, ty)
        assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
        assert_allclose(tacc, jacc, rtol=TOL, atol=TOL)
        for k in jparams:
            assert_allclose(tparams[k], jparams[k], rtol=TOL, atol=TOL,
                            err_msg=f"step {step} {k}")
            for m in ("m", "v"):
                assert_allclose(tstate[m][k], jstate[m][k], rtol=TOL,
                                atol=TOL, err_msg=f"step {step} {m} {k}")
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1


def test_segment_atrous_cli_runs_on_the_cpu(capsys):
    params = tex.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step    1" in out and "device=cpu" in out
    assert set(params) == {"rate1", "rate2", "rate4", "fuse"}
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


# -- train_cnn_ecoflow / train_gan / serve_lm ---------------------------------

def _trees_close(got, want, what):
    """Every leaf of the port's tree within TOL of `repro`'s, leaves paired
    by path in jax's order."""
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    tleaves = tree_paths(got)
    assert [p for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves], what
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert_allclose(t, j, rtol=TOL, atol=TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("step,batch,size", [(0, 32, 24), (3, 32, 24),
                                             (1, 5, 16)])
def test_cnn_synth_batch_is_repros_bit_for_bit(step, batch, size):
    jx, jy = _repro_example("train_cnn_ecoflow").synth_batch(
        step, batch=batch, size=size)
    tx, ty = tcnn_ex.synth_batch(step, batch=batch, size=size)
    assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("step,batch,size", [(0, 16, 32), (4, 16, 32),
                                             (2, 3, 8)])
def test_gan_real_batch_and_latents_are_repros_bit_for_bit(step, batch, size):
    jreal = _repro_example("train_gan").real_batch(step, batch=batch,
                                                   size=size)
    treal = tgan_ex.real_batch(step, batch=batch, size=size)
    assert treal.dtype == torch.float32
    assert np.array_equal(treal.numpy(), np.asarray(jreal))
    # examples/train_gan.py:68-69
    rng = np.random.default_rng(np.random.SeedSequence([3, step]))
    jz = jnp.asarray(rng.standard_normal((batch, 32)), jnp.float32)
    assert np.array_equal(tgan_ex.noise(step, batch=batch).numpy(),
                          np.asarray(jz))


def test_train_cnn_ecoflow_steps_match_repro():
    jex = _repro_example("train_cnn_ecoflow")
    jparams = jcnn.simple_cnn_init(jax.random.PRNGKey(0),
                                   widths=tcnn_ex.WIDTHS, n_classes=10)
    kw = dict(lr=2e-3, warmup_steps=20, total_steps=3, weight_decay=0.01)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstate = jopt.adamw_init(jparams, jcfg)

    @jax.jit
    def jstep(params, opt, x, y):        # examples/train_cnn_ecoflow.py:51-59
        loss, grads = jax.value_and_grad(
            lambda p: jcnn.cnn_loss(p, x, y, stride=2,
                                    backend="xla_zero_free"))(params)
        params, opt, _ = jopt.adamw_update(grads, opt, params, jcfg)
        acc = jnp.mean(jnp.argmax(jcnn.simple_cnn_apply(
            params, x, stride=2, backend="xla_zero_free"), -1) == y)
        return params, opt, loss, acc

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tstate = topt.adamw_init(tparams, tcfg)
    tstep = tcnn_ex.make_step(tcfg, backend="cuda")
    for step in range(3):
        jparams, jstate, jloss, jacc = jstep(jparams, jstate,
                                             *jex.synth_batch(step))
        tparams, tstate, tloss, tacc = tstep(tparams, tstate,
                                             *tcnn_ex.synth_batch(step))
        assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
        assert_allclose(tacc, jacc, rtol=TOL, atol=TOL)
        _trees_close(tparams, jparams, f"step {step} params")
        _trees_close(tstate, jstate, f"step {step} opt")


def test_train_gan_steps_match_repro():
    jex = _repro_example("train_gan")
    Z, BASE, B = tgan_ex.Z, tgan_ex.BASE, tgan_ex.BATCH
    gp = jgan.generator_init(jax.random.PRNGKey(0), z_dim=Z, base=BASE)
    dp = jgan.discriminator_init(jax.random.PRNGKey(1), base=BASE)
    kw = dict(lr=2e-4, b1=0.5, warmup_steps=0, total_steps=3,
              weight_decay=0.0)
    jcfg = jopt.AdamWConfig(**kw)
    tgcfg, tdcfg = tgan_ex.adamw_configs(3)
    assert tgcfg == tdcfg == topt.AdamWConfig(**kw)
    g_opt, d_opt = jopt.adamw_init(gp, jcfg), jopt.adamw_init(dp, jcfg)

    @jax.jit
    def jstep(gp, dp, g_opt, d_opt, z, real):   # examples/train_gan.py:53-62
        be = "xla_zero_free"
        d_loss, d_grads = jax.value_and_grad(
            lambda d: jgan.gan_losses(gp, d, z, real, backend=be)[1])(dp)
        dp, d_opt, _ = jopt.adamw_update(d_grads, d_opt, dp, jcfg)
        g_loss, g_grads = jax.value_and_grad(
            lambda g: jgan.gan_losses(g, dp, z, real, backend=be)[0])(gp)
        gp, g_opt, _ = jopt.adamw_update(g_grads, g_opt, gp, jcfg)
        return gp, dp, g_opt, d_opt, g_loss, d_loss

    t = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
         for p in (gp, dp)]
    t += [topt.adamw_init(t[0], tgcfg), topt.adamw_init(t[1], tdcfg)]
    tstep = tgan_ex.make_step(tgcfg, tdcfg, backend="cuda")
    j = [gp, dp, g_opt, d_opt]
    for step in range(3):
        rng = np.random.default_rng(np.random.SeedSequence([3, step]))
        z = jnp.asarray(rng.standard_normal((B, Z)), jnp.float32)
        *j, jgl, jdl = jstep(*j, z, jex.real_batch(step, batch=B))
        *t, tgl, tdl = tstep(*t, tgan_ex.noise(step),
                             tgan_ex.real_batch(step, batch=B))
        assert_allclose(tgl, jgl, rtol=TOL, atol=TOL)
        assert_allclose(tdl, jdl, rtol=TOL, atol=TOL)
        for what, tt, jj in zip(("gen", "disc", "gen opt", "disc opt"), t,
                                j):
            _trees_close(tt, jj, f"step {step} {what}")


def test_serve_lm_requests_are_repros_bit_for_bit():
    # examples/serve_lm.py:36-42
    rng = np.random.default_rng(0)
    want = [rng.integers(1, 512, int(rng.integers(3, 12)),
                         dtype=np.int64).astype(np.int32) for _ in range(10)]
    got = tserve.make_requests(512, 10, 12)
    assert [r.uid for r in got] == list(range(10))
    assert all(r.max_new_tokens == 12 for r in got)
    for r, p in zip(got, want):
        assert r.prompt.dtype == np.int32 and np.array_equal(r.prompt, p)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-0.6b"])
def test_serve_lm_tokens_match_repro(arch):
    """`repro`'s example serving on fp32 params, and the port's engine on
    the same params (`repro`'s init) and the same requests."""
    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro.models.lm import LM as JLM
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.engine import ServeEngine
    jcfg = j_get_smoke_config(arch).scaled(dtype="float32")
    tcfg = get_smoke_config(arch).scaled(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    reqs = tserve.make_requests(tcfg.vocab, 10, 12)
    jreqs = [JRequest(uid=r.uid, prompt=r.prompt.copy(),
                      max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jcfg, jparams, batch=4, max_len=tserve.MAX_LEN)
    teng = ServeEngine(tcfg, tparams, batch=4, max_len=tserve.MAX_LEN,
                       device="cpu")
    want = jeng.generate(jreqs)
    assert teng.generate(reqs) == want
    assert teng.stats == jeng.stats


def test_train_cnn_ecoflow_cli_runs_on_the_cpu(capsys):
    params = tcnn_ex.main(["--device", "cpu", "--steps", "40"])
    out = capsys.readouterr().out
    assert "step   39" in out and "device=cpu" in out
    assert len(params["convs"]) == 3
    assert all(bool(torch.isfinite(p).all()) for _, p in tree_paths(params))


def test_train_gan_cli_runs_on_the_cpu(capsys):
    gp, dp = tgan_ex.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step    1" in out and "(16, 32, 32, 3)" in out
    assert set(gp) == {"proj", "t1", "t2", "t3"}
    assert set(dp) == {"c1", "c2", "c3", "head"}


def test_serve_lm_cli_runs_on_the_cpu(capsys):
    results = tserve.main(["--device", "cpu", "--requests", "6",
                           "--max-new", "3"])
    out = capsys.readouterr().out
    assert sorted(results) == list(range(6))
    assert all(len(v) == 3 for v in results.values())
    assert "6 requests, 18 tokens" in out
