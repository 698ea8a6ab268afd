"""The port's example programs (`repro_torch/examples/`) on the CPU against
`repro`'s (`examples/`, loaded with importlib: not a package).

`segment_atrous`: the synthetic batches are `repro`'s bit for bit; three
training steps (the atrous loss's gradients, AdamW, the post-update
logits' pixel accuracy) at batch 2, 24x24 on the port's `cuda` backend
(the kernels' plain versions on CPU tensors) equal `repro`'s example step
on `xla_zero_free` within 1e-4: losses, accuracies, every param and the
optimizer state."""
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
from repro_torch.convert import params_from_numpy
from repro_torch.examples import segment_atrous as tex
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
