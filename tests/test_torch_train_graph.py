"""The LM `Trainer`'s step compiled once (`train/step_graph.py` with
`eager_first`, `train/trainer.py::committing_step`).

On the card the step is one CUDA graph per run: the state in fixed
buffers, each batch copied into the graph's batch buffers, the new state
copied into the state buffers inside the graph.  On the CPU:
  * the step as the graph wraps it (`committing_step` on state buffers
    and batch buffers that are written in place) over 3 steps against
    `repro`'s jitted `Trainer` step (`jax.jit(make_train_step(...),
    donate_argnums=(0, 1))`) for qwen3-0.6b and moonshot-v1-16b-a3b at
    their SMOKE configs in fp32, one microbatch as `repro`'s Trainer
    takes: params, moments, count and losses within 1e-4 after every
    step, the buffers' storage never reallocated;
  * the step draws no random numbers (the CPU generator's state is the
    same after it), so no value depends on the activation checkpoints'
    saved RNG state;
  * a `Trainer` on the CPU holds no graph (`captures == 0`) and
    `StepGraph` refuses a CPU device;
  * every capture (`device.capture`) pauses Python's cyclic garbage
    collector and restores it.
The `gpu`-marked tests (skipped without a card; no JAX in them, so they
run on the card's machine with `-m gpu`) hold a graphed run of 3 steps
bit-equal to the same steps run eagerly, with one capture and the
replays' launches counted from it (a dense model at one microbatch
too); a checkpointed run that fails after step 3 and resumes bit-equal
to the run without the fault; and a capture
that reads a device value raising, with no fallback.  `repro` is
imported inside a fixture, so this file imports no JAX at collection.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import TokenDataset
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.train.step_graph import StepGraph

TOL = 1e-4
ARCHS = ["qwen3_0_6b", "moonshot_v1_16b_a3b"]
STEPS = 3
OPT = dict(lr=3e-3, warmup_steps=0, total_steps=10, eps=1e-6)


@pytest.fixture(scope="module")
def jx():
    """`repro`'s modules, imported here so the card's machine (no JAX)
    collects this file."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro.data import pipeline as jpipe
    from repro.launch import steps as jsteps
    from repro.models.lm import LM as JLM
    from repro.optim import optimizer as jopt
    return dict(jax=jax, jnp=jnp, config=j_get_smoke_config, pipe=jpipe,
                steps=jsteps, LM=JLM, opt=jopt)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _assert_tree_close(jx, got, want, what):
    jax, jnp = jx["jax"], jx["jnp"]
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert_allclose(a.detach().float().numpy(),
                        np.asarray(jnp.asarray(b, jnp.float32)), rtol=TOL,
                        atol=TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_committing_step_matches_repros_jitted_step(jx, arch):
    from repro_torch.convert import params_from_numpy
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg = jx["config"](arch).scaled(dtype="float32", microbatch=1)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    jo, to = jx["opt"].AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    np_params = _noisy(jax.jit(jx["LM"](jcfg).init)(
        jax.random.PRNGKey(0)), 1)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstep = jax.jit(jx["steps"].make_train_step(jcfg, jo),
                    donate_argnums=(0, 1))
    jstate = (jp, jx["opt"].adamw_init(jp, jo))
    ds = jx["pipe"].TokenDataset(vocab=jcfg.vocab, seq_len=16,
                                 global_batch=2, seed=0)

    tp = params_from_numpy(np_params, device="cpu")
    state = {"params": tp, "opt": topt.adamw_init(tp, to)}
    ptrs = [t.data_ptr() for t in tL.tree_leaves(state)]
    data = tuple(torch.empty(ds.batch(0)[k].shape,
                             dtype=torch.from_numpy(ds.batch(0)[k]).dtype)
                 for k in ttrainer.BATCH_KEYS)
    step = ttrainer.committing_step(tsteps.make_train_step(tcfg, to))
    for i in range(STEPS):
        batch = ds.batch(i)
        for buf, k in zip(data, ttrainer.BATCH_KEYS):
            buf.copy_(torch.from_numpy(batch[k]))
        metrics = step(state, data)
        jp2, jo2, jm = jstep(*jstate, batch)
        jstate = (jp2, jo2)
        assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=TOL,
                        atol=TOL, err_msg=f"step {i + 1}")
        _assert_tree_close(jx, state["params"], jp2, f"step {i + 1}")
        _assert_tree_close(jx, state["opt"], jo2, f"step {i + 1}")
    assert int(state["opt"]["count"]) == STEPS
    assert [t.data_ptr() for t in tL.tree_leaves(state)] == ptrs


def test_the_step_draws_no_random_numbers():
    """The step's activation checkpoints (remat "full") save and restore
    the RNG state around each recompute; the step draws nothing from it,
    so the generator's state is the same after a step."""
    cfg = get_smoke_config("qwen3-0.6b").scaled(dtype="float32")
    assert cfg.remat == "full"
    tr = ttrainer.Trainer(cfg, TokenDataset(vocab=cfg.vocab, seq_len=16,
                                            global_batch=4, seed=0),
                          topt.AdamWConfig(**OPT), device="cpu")
    params, opt, _ = tr.init_state()
    batch = {k: torch.from_numpy(v) for k, v in tr.dataset.batch(0).items()}
    before = torch.get_rng_state()
    _, _, metrics = tr.step_fn(params, opt, batch)
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.isfinite(metrics["loss"])


def test_a_cpu_trainer_holds_no_graph():
    cfg = get_smoke_config("qwen3-0.6b").scaled(dtype="float32")
    tr = ttrainer.Trainer(cfg, TokenDataset(vocab=cfg.vocab, seq_len=16,
                                            global_batch=4, seed=0),
                          topt.AdamWConfig(**OPT),
                          ttrainer.TrainerConfig(total_steps=2, log_every=1),
                          device="cpu")
    out = tr.run()
    assert tr.graph is None and tr.captures == 0
    assert len(out["history"]) == 2
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraph(lambda s, d: {}, torch.device("cpu"), lr=False,
                  eager_first=True)


def test_a_capture_pauses_the_garbage_collector(monkeypatch):
    """`device.capture` (every capture of the port) runs the capture with
    Python's cyclic collector paused -- a collection could destroy a dead
    engine's graphs mid-capture -- and restores it, on an error too."""
    import contextlib
    import gc

    from repro_torch import device

    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        seen.append((gc.isenabled(), g, pool, stream))
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    with device.capture("g", stream="s", pool="p"):
        assert not gc.isenabled()
    assert gc.isenabled() and seen == [(False, "g", "p", "s")]
    with pytest.raises(RuntimeError, match="capture failed"):
        with device.capture("g", stream="s"):
            raise RuntimeError("capture failed")
    assert gc.isenabled()


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_trainer(arch, cuda, ckpt_dir=None, steps=STEPS, microbatch=None):
    cfg = get_smoke_config(arch)
    if microbatch is not None:
        cfg = cfg.scaled(microbatch=microbatch)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    return ttrainer.Trainer(cfg, ds, topt.AdamWConfig(
        lr=3e-3, warmup_steps=0, total_steps=steps), ttrainer.TrainerConfig(
        total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=1,
        keep_last=2), device=cuda)


def _eager(tr, steps=STEPS):
    """`tr.step_fn` eagerly from the trainer's seeded init over the
    dataset's first `steps` batches: (params, opt, losses)."""
    params, opt, _ = tr.init_state()
    losses = []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(tr.device)
             for k, v in tr.dataset.batch(i).items()}
        params, opt, m = tr.step_fn(params, opt, b)
        losses.append(float(m["loss"]))
    return params, opt, losses


def _bit_equal(a, b):
    la, lb = tL.tree_leaves(a), tL.tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.gpu
@pytest.mark.parametrize("arch, microbatch", [
    ("qwen3-0.6b", None), ("qwen3-0.6b", 1), ("moonshot-v1-16b-a3b", None)])
def test_a_graphed_run_equals_the_eager_steps(cuda, arch, microbatch):
    """Step 1 eager, step 2 captured and replayed, step 3 replayed: the
    losses and the final state bit-equal to 3 eager steps; one capture;
    `ops.LAUNCHES` counts the eager step and the capture, the replays'
    launches are the capture's, twice.  At one microbatch a dense model's
    aux loss is the constant 0.0, made on the card by a fill (a copy from
    the host would break the capture)."""
    tr = _card_trainer(arch, cuda, microbatch=microbatch)
    ops.reset_launches()
    out = tr.run()
    torch.cuda.synchronize()
    counted = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert tr.captures == 1 and tr.graph.graph is None      # released
    per_step = tr.graph.launches
    assert per_step["flash_attention"] > 0
    assert counted == {k: 2 * n for k, n in per_step.items()}
    assert tr.graph.replay_launches == {k: 2 * n for k, n in per_step.items()}
    params, opt, losses = _eager(tr)
    assert [h["loss"] for h in out["history"]] == losses
    assert _bit_equal(out["params"], params) and _bit_equal(out["opt"], opt)


@pytest.mark.gpu
def test_a_failure_and_resume_under_the_graph_equal_the_straight_run(
        cuda, tmp_path):
    steps = 4
    ref = _card_trainer("qwen3-0.6b", cuda, str(tmp_path / "a"), steps).run()
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _card_trainer("qwen3-0.6b", cuda, str(tmp_path / "b"),
                      steps).run(fail_at_step=3)
    tr = _card_trainer("qwen3-0.6b", cuda, str(tmp_path / "b"), steps)
    out = tr.run()
    assert tr.captures == 1        # steps 3 (eager) and 4 (the capture)
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][2:]]
    assert _bit_equal(out["params"], ref["params"])
    assert _bit_equal(out["opt"], ref["opt"])


@pytest.mark.gpu
def test_a_capture_that_reads_a_device_value_raises(cuda, monkeypatch):
    """An op that reads a device value to the host runs at the eager first
    step and breaks the capture at the second: the run raises, nothing
    falls back to an eager step."""
    real = tsteps.adamw_update

    def syncing(grads, opt_state, params, cfg, **kw):
        float(opt_state["count"])            # a host read of the card
        return real(grads, opt_state, params, cfg, **kw)

    monkeypatch.setattr(tsteps, "adamw_update", syncing)
    tr = _card_trainer("qwen3-0.6b", cuda)
    with pytest.raises(RuntimeError):
        tr.run()
    assert tr.captures == 0 and tr.graph.graph is None
