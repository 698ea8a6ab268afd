"""The port's optimizers (`repro_torch/optim/optimizer.py`) on the CPU
against `repro/optim/optimizer.py`: AdamW and Lion over 5 steps on the
same numpy params and gradients, with a warmup, the cosine decay to the
last step, clipping that bites, weight decay on the matrices, and fp32
or bf16 moments (and AdamW's bf16 params with an fp32 master).  Params,
moments, master and the step counter after every step within 1e-6
(fp32: both sides compute the same ops in the same order), the grad norm
and lr within 1e-6."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.optim import optimizer as jopt
from repro_torch.models.layers import tree_map, tree_paths
from repro_torch.optim import optimizer as topt

TOL = 1e-6
STEPS = 5


def _params(rng):
    return {"conv": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "head": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                     "b": rng.standard_normal(3).astype(np.float32)}}


def _grads(rng, params):
    # norms of about 10: clip_norm 1 scales every step
    return jax.tree.map(
        lambda p: (3.0 * rng.standard_normal(p.shape)).astype(np.float32),
        params)


def _numpy(t):
    return np.asarray(t.float() if t.dtype == torch.bfloat16 else t)


def _hold(got, want):
    """Every leaf of the port's tree against `repro`'s (jax's sorted key
    order on both sides)."""
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree_paths(got)
    assert [jax.tree_util.keystr(p) for p, _ in want_leaves] == \
        [p for p, _ in got_leaves]
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        assert_allclose(_numpy(g), np.asarray(w, np.float32), rtol=TOL,
                        atol=TOL, err_msg=jax.tree_util.keystr(path))


CASES = {
    "adamw": (jopt.AdamWConfig, topt.AdamWConfig, "adamw", {}),
    "adamw_bf16_moments": (jopt.AdamWConfig, topt.AdamWConfig, "adamw",
                           {"moment_dtype": "bfloat16"}),
    "adamw_bf16_params": (jopt.AdamWConfig, topt.AdamWConfig, "adamw",
                          {"bf16_params": True}),
    "lion": (jopt.LionConfig, topt.LionConfig, "lion", {}),
    "lion_bf16_moments": (jopt.LionConfig, topt.LionConfig, "lion",
                          {"moment_dtype": "bfloat16"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_repro_over_five_steps(case):
    jcfg_t, tcfg_t, kind, extra = CASES[case]
    kw = dict(lr=0.05, warmup_steps=2, total_steps=STEPS, clip_norm=1.0,
              weight_decay=0.1, **extra)
    jcfg, tcfg = jcfg_t(**kw), tcfg_t(**kw)
    rng = np.random.default_rng(0)
    p_np = _params(rng)
    jinit, jupd = (jopt.adamw_init, jopt.adamw_update) if kind == "adamw" \
        else (jopt.lion_init, jopt.lion_update)
    tinit, tupd = (topt.adamw_init, topt.adamw_update) if kind == "adamw" \
        else (topt.lion_init, topt.lion_update)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = tree_map(torch.tensor, p_np)
    if kind == "adamw":
        jp = jopt.cast_params_for_storage(jp, jcfg)
        tp = topt.cast_params_for_storage(tp, tcfg)
    js, ts = jinit(jp, jcfg), tinit(tp, tcfg)
    update = jax.jit(lambda g, s, p: jupd(g, s, p, jcfg))
    for _ in range(STEPS):
        g_np = _grads(rng, p_np)
        jg = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype),
                          g_np, jp)
        tg = tree_map(lambda a, p: torch.tensor(a).to(p.dtype), g_np, tp)
        jp, js, jm = update(jg, js, jp)
        tp, ts, tm = tupd(tg, ts, tp, tcfg)
        _hold(tp, jp)
        _hold(ts, js)
        for name in ("grad_norm", "lr"):
            assert tm[name].dim() == 0 and tm[name].dtype == torch.float32
            assert_allclose(_numpy(tm[name]), np.asarray(jm[name]),
                            rtol=TOL, atol=TOL)
        assert float(jm["grad_norm"]) > kw["clip_norm"]   # the clip bites
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == STEPS


def test_cosine_schedule_matches_repro():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=40)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(jopt.cosine_schedule(jopt.AdamWConfig(**cfg),
                                           jnp.asarray(steps)))
    got = topt.cosine_schedule(topt.AdamWConfig(**cfg), torch.tensor(steps))
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-9)
