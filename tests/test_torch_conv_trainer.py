"""The port's conv trainer slice on the CPU against `repro`: `StepGuard`,
the seeded training faults, and `ConvTrainer` itself -- resumed from a
checkpoint `repro`'s trainer wrote, it must land within TOL of `repro`'s
straight run -- plus the loop's own behaviour (resume, rollback, skip,
shrink-lr, give-up with `repro`'s blame strings, kernel faults), mirroring
tests/test_conv_trainer.py.

Sizes are `repro`'s test sizes (tests/test_conv_trainer.py): the CNN at
widths (4,), 8x8 images, 4 classes; the GANs at z_dim 8, base 4; batch
4, 6 steps.  `repro` runs on `xla_zero_free`, the port on its `cuda`
backend, whose wrappers take the kernels' plain versions on CPU tensors.
Tolerance: state and every loss within rtol = atol = 1e-4 (fp32 on both
sides; only the order of the sums differs).  Runs of the port against
the port are compared bit for bit.
"""
from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro.data.pipeline import ConvDataset
from repro.serve import faults as jfaults
from repro.train import checkpoint as jckpt
from repro.train import conv_trainer as jtrainer
from repro.train import fault_tolerance as jft
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.serve import faults as tfaults
from repro_torch.train import conv_trainer as ttrainer
from repro_torch.train import fault_tolerance as tft

TOL = 1e-4
SIZES = {"cnn": dict(widths=(4,), image=8, n_classes=4),
         "gan_gen": dict(z_dim=8, base=4),
         "gan": dict(z_dim=8, base=4)}


def _repro_cfg(workload, **kw):
    base = dict(workload=workload, total_steps=6, batch=4,
                backend="xla_zero_free", ckpt_every=2, seed=0,
                **SIZES[workload])
    base.update(kw)
    return jtrainer.ConvTrainerConfig(**base)


def _port_cfg(workload, **kw):
    base = dict(workload=workload, total_steps=6, batch=4, backend="cuda",
                ckpt_every=2, seed=0, **SIZES[workload])
    base.update(kw)
    return ttrainer.ConvTrainerConfig(**base)


def _port(workload, injector=None, **kw):
    return ttrainer.ConvTrainer(_port_cfg(workload, **kw), injector=injector,
                                device="cpu")


def _assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _inj(pkg, workload, *events):
    site = pkg.train_site(workload)
    return pkg.FaultInjector(pkg.FaultSchedule(
        [pkg.FaultEvent(site, i, kind) for i, kind in events]))


# -- StepGuard ----------------------------------------------------------------

GUARD_SEQS = ["nnn", "ngnnnngnn", "nnnnnnnn", "gnngnnng"]


@pytest.mark.parametrize("seq", GUARD_SEQS)
@pytest.mark.parametrize("policy,max_retries", [("skip", 2), ("skip", 3),
                                                ("shrink_lr", 2),
                                                ("shrink_lr", 4)])
def test_step_guard_matches_repro(policy, max_retries, seq):
    """The same failure ('n') / good-step ('g') sequence gives the same
    decisions and stats as repro's guard, after every event."""
    kw = dict(max_retries=max_retries, nonfinite_policy=policy,
              lr_shrink=0.25)
    got, want = tft.StepGuard(**kw), jft.StepGuard(**kw)
    for ev in seq:
        if ev == "n":
            a, b = got.nonfinite(), want.nonfinite()
            assert (a.action, a.lr_scale) == (b.action, b.lr_scale)
        else:
            got.good_step()
            want.good_step()
        assert got.stats == want.stats


def test_step_guard_validation_and_watchdog():
    for kw in (dict(nonfinite_policy="explode"), dict(max_retries=0)):
        with pytest.raises(ValueError):
            tft.StepGuard(**kw)
    g = tft.StepGuard(step_timeout_s=0.0)
    assert not g.straggled()            # no step started
    g.start_step()
    assert g.straggled() and g.stats["stragglers"] == 1
    assert not tft.StepGuard().straggled()
    e = tft.HostFailure(3, [2, 1])
    assert (e.step, e.hosts, str(e)) == (3, (1, 2),
                                         str(jft.HostFailure(3, [2, 1])))


# -- faults --------------------------------------------------------------------

def _events(sched):
    return [(e.site, e.index, e.kind, e.magnitude) for e in sched.events]


@pytest.mark.parametrize("seed", [0, 4, 17])
def test_seeded_schedules_match_repro(seed):
    kw = dict(sites=["a", "train.cnn", "host:3"], rate=0.2, horizon=40,
              magnitude=0.5)
    assert _events(tfaults.FaultSchedule.seeded(seed, **kw)) == \
        _events(jfaults.FaultSchedule.seeded(seed, **kw))
    for wl in ("cnn", "gan"):
        kw = dict(workload=wl, n_steps=64, rate=0.3)
        assert _events(tfaults.training_schedule(seed, **kw)) == \
            _events(jfaults.training_schedule(seed, **kw))
    kw = dict(n_hosts=4, n_steps=50, rate=0.1)
    assert tft.host_failure_schedule(seed, **kw) == \
        jft.host_failure_schedule(seed, **kw)


def test_schedule_validation():
    with pytest.raises(ValueError):
        tfaults.FaultSchedule.seeded(0, sites=["a"], rate=1.5)
    with pytest.raises(ValueError):
        tfaults.FaultSchedule.seeded(0, sites=["a"], rate=0.1,
                                     kinds=("meteor",))
    with pytest.raises(ValueError):
        tfaults.FaultEvent("a", 0, "meteor")


@pytest.mark.parametrize("kind", ["nan_output", "inf_output",
                                  "latency_spike"])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_poison_batch_matches_repro(workload, kind):
    batch = ConvDataset(kind=workload, batch=3, image=6, z_dim=5,
                        seed=2).batch_at(1)
    ev_t = tfaults.FaultEvent("s", 0, kind)
    ev_j = jfaults.FaultEvent("s", 0, kind)
    got = tfaults.poison_batch(
        tfaults.FaultInjector(tfaults.FaultSchedule()), ev_t, batch)
    want = jfaults.poison_batch(
        jfaults.FaultInjector(jfaults.FaultSchedule()), ev_j, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tfaults.poison_batch(None, None, batch) is batch


def test_injector_acts_like_repros():
    evs = [(0, "kernel_exception"), (1, "device_loss"), (2, "latency_spike"),
           (3, "nan_output")]
    t, j = _inj(tfaults, "cnn", *evs), _inj(jfaults, "cnn", *evs)
    for cls in (tfaults.InjectedKernelFault, tfaults.InjectedDeviceLoss):
        with pytest.raises(cls) as ei:
            t.raise_or_delay("train.cnn")
        assert isinstance(ei.value, tfaults.InjectedFault)
        with pytest.raises(jfaults.InjectedFault) as ej:
            j.raise_or_delay("train.cnn")
        assert str(ei.value) == str(ej.value)
    assert t.raise_or_delay("train.cnn") is None
    assert t.raise_or_delay("train.cnn").kind == "nan_output"
    assert t.raise_or_delay("train.cnn") is None
    assert [e.index for e in t.fired] == [0, 1, 2, 3]
    assert t.poison(None, np.ones(3)).tolist() == [1.0, 1.0, 1.0]


# -- the trainer against repro ---------------------------------------------------

@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """repro's straight 6-step run of each workload, with its checkpoints
    at steps 2, 4 and 6 (cached for the module)."""
    runs = {}

    def get(workload):
        if workload not in runs:
            d = tmp_path_factory.mktemp(f"repro_{workload}")
            out = jtrainer.ConvTrainer(
                _repro_cfg(workload, ckpt_dir=str(d))).run()
            runs[workload] = (out, d)
        return runs[workload]
    return get


@pytest.mark.parametrize("workload", ["cnn", "gan_gen", "gan"])
def test_trainer_resumed_from_repros_step_2_matches_repros_run(
        workload, repro_runs, tmp_path):
    want, d = repro_runs(workload)
    shutil.copytree(d / "step_2", tmp_path / "step_2")
    (tmp_path / "LATEST").write_text("2")
    out = _port(workload, ckpt_dir=str(tmp_path)).run()
    assert out["start_step"] == 2
    assert [h["step"] for h in out["history"]] == [3, 4, 5, 6]
    assert_allclose([h["loss"] for h in out["history"]],
                    [h["loss"] for h in want["history"][2:]],
                    rtol=TOL, atol=TOL)
    got = tree_paths(out["state"])
    ref = jax.tree_util.tree_flatten_with_path(want["state"])[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                        err_msg=path)
    assert out["guard_stats"] == want["guard_stats"]
    # The port's own checkpoint at step 6 is one repro can restore.
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), want["state"])
    back = jckpt.restore(str(tmp_path), 6, like)
    for (_, a), b in zip(got, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("workload", ["cnn", "gan_gen", "gan"])
def test_give_up_blames_the_leaves_repro_blames(workload):
    """Every attempt of step 0 poisoned, shrink-lr with 2 retries: both
    trainers give up at step 0 naming the same leaves."""
    evs = [(i, "nan_output") for i in range(4)]
    kw = dict(nonfinite_policy="shrink_lr", max_retries=2)
    tr = _port(workload, _inj(tfaults, workload, *evs), **kw)
    with pytest.raises(ttrainer.NonFiniteStepError) as got:
        tr.run()
    jt = jtrainer.ConvTrainer(_repro_cfg(workload, **kw),
                              injector=_inj(jfaults, workload, *evs))
    with pytest.raises(jtrainer.NonFiniteStepError) as want:
        jt.run()
    assert got.value.step == want.value.step == 0
    assert len(got.value.blame) > 0
    assert got.value.blame == want.value.blame
    assert str(got.value) == str(want.value)
    assert tr.guard.stats == jt.guard.stats
    assert [b["grads"] for b in tr.blames] == [b["grads"] for b in jt.blames]


# -- the loop's own behaviour ----------------------------------------------------

@pytest.mark.parametrize("workload", ["cnn", "gan_gen"])
def test_resume_bit_exact(workload, tmp_path):
    d = str(tmp_path / "ckpt")
    _port(workload, total_steps=4, ckpt_dir=d).run()
    out_r = _port(workload, ckpt_dir=d).run()
    assert out_r["start_step"] == 4
    assert [h["step"] for h in out_r["history"]] == [5, 6]
    out_s = _port(workload).run()
    _assert_bit_equal(out_r["state"], out_s["state"])
    assert out_r["history"] == out_s["history"][4:]


def test_async_checkpoints_equal_blocking_ones(tmp_path):
    out_a = _port("gan", ckpt_dir=str(tmp_path / "a"),
                  async_checkpoint=True).run()
    out_b = _port("gan", ckpt_dir=str(tmp_path / "b")).run()
    _assert_bit_equal(out_a["state"], out_b["state"])
    for step in (4, 6):
        for i in range(8):
            np.testing.assert_array_equal(
                np.load(tmp_path / "a" / f"step_{step}" / f"leaf_{i}.npy"),
                np.load(tmp_path / "b" / f"step_{step}" / f"leaf_{i}.npy"))


def test_nan_poison_rollback_retry_matches_fault_free():
    faulted = _port("cnn", _inj(tfaults, "cnn", (1, "nan_output"))).run()
    clean = _port("cnn").run()
    # rollback + retry of the SAME step with a clean re-fetch: the final
    # params are EXACTLY the fault-free ones
    _assert_bit_equal(faulted["state"], clean["state"])
    assert faulted["history"] == clean["history"]
    assert faulted["guard_stats"]["nonfinite_steps"] == 1
    assert faulted["guard_stats"]["retries"] == 1
    assert len(faulted["blames"]) == 1
    assert faulted["blames"][0]["injected"] is True
    assert faulted["blames"][0]["grads"] == ["['convs'][0]", "['head']"]


def test_skip_policy_abandons_step():
    out = _port("cnn", _inj(tfaults, "cnn", (1, "nan_output"),
                            (2, "nan_output")),
                nonfinite_policy="skip").run()
    assert out["guard_stats"]["skips"] == 1
    steps = [h["step"] for h in out["history"]]
    assert steps == [1, 3, 4, 5, 6]


def test_shrink_lr_policy_retries_at_reduced_lr():
    evs = [(1, "nan_output"), (2, "nan_output")]
    out = _port("cnn", _inj(tfaults, "cnn", *evs),
                nonfinite_policy="shrink_lr", max_retries=3).run()
    want = jtrainer.ConvTrainer(
        _repro_cfg("cnn", nonfinite_policy="shrink_lr", max_retries=3),
        injector=_inj(jfaults, "cnn", *evs)).run()
    assert out["guard_stats"] == want["guard_stats"]
    assert out["guard_stats"]["lr_shrinks"] == 1
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5, 6]
    # step 2 (index 1) ran at lr * 0.5, every other step at lr: the same
    # eager steps give the same state bit for bit
    tr = _port("cnn")
    fn, state = tr.build_step(guarded=True), tr.init_state()
    for i in range(6):
        lr = 0.05 * (0.5 if i == 1 else 1.0)
        state, _, _ = fn(state, tr._put_batch(tr.data.batch_at(i)),
                         torch.tensor(lr, dtype=torch.float32))
    _assert_bit_equal(out["state"], state)


def test_kernel_fault_annotated_with_train_step():
    with pytest.raises(tfaults.InjectedKernelFault) as ei:
        _port("cnn", _inj(tfaults, "cnn", (2, "kernel_exception"))).run()
    assert ei.value.train_step == 2


@pytest.mark.parametrize("workload", ["cnn", "gan_gen", "gan"])
def test_guard_adds_no_kernel_launch(workload, monkeypatch):
    """On CPU tensors each wrapper runs its kernel's plain version where
    the card launches the kernel: the guarded step reaches them exactly
    as often as the unguarded one, and never reads the flag."""
    from repro_torch.kernels import ops as tops
    calls = []
    for name in ("dconv_forward_plain", "tconv_fused_plain",
                 "tconv_implicit_gemm_plain", "conv_backward_plain",
                 "tconv_backward_plain", "dconv_filter_grad_plain"):
        def wrap(*a, _f=getattr(tops, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(tops, name, wrap)
    tr = _port(workload)
    state, data = tr.init_state(), tr._put_batch(tr.data.batch_at(0))
    counts = []
    for guarded in (True, False):
        calls.clear()
        _, _, fin = tr.build_step(guarded=guarded)(state, data,
                                                    torch.tensor(0.05))
        assert isinstance(fin, torch.Tensor) and fin.dim() == 0
        counts.append(sorted(calls))
    assert counts[0] == counts[1] and counts[0]


def test_unguarded_step_and_cpu_trainer_capture_nothing():
    tr = _port("gan", guard=False)
    state = tr.init_state()
    data = tr._put_batch(tr.data.batch_at(0))
    new, metrics, fin = tr.build_step(guarded=False)(
        state, data, torch.tensor(0.05))
    assert fin.dtype == torch.bool and fin.dim() == 0 and bool(fin)
    assert sorted(metrics) == ["d_loss", "loss"]
    out = tr.run()
    assert tr.captures == 0 and tr.graph is None
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5, 6]
    with pytest.raises(ValueError):
        ttrainer.ConvTrainerConfig(workload="lm")
