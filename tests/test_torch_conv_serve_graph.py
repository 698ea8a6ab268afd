"""`ConvServeEngine`'s launches compiled once (`serve/conv_graph.py`).

On the card each (bucket, rung) launch is one CUDA graph: the first
launch runs eagerly and is served, the capture follows, every later
launch is a replay.  On the CPU:
  * the engine holds no graph (`captures == 0`) and serves as `repro`'s
    engine does, results within 1e-4 and the same accounting, over two
    `serve` calls on one engine;
  * a rung whose backend fires Python-side events per op
    (`serve.faults.inject_backend`'s, which is not `graphable`) is never
    graphed -- its events fire on every launch -- while every other rung
    is, on a card (the decision `ConvServeEngine.graphed`, with the device
    faked), and a ladder holding such a rung is not graphable;
  * `ConvGraph` refuses a CPU device.
The `gpu`-marked tests (skipped without a card; no JAX in them, so they
run on the card's machine with `-m gpu`) hold every (bucket, rung)
replay bit-equal to its eager forward, the captures and the replays'
launch accounting, and the `@inject` rung eager on the card.
`repro` is imported inside a fixture, so this file imports no JAX at
collection.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import assert_allclose
from repro_torch.core import spec as tspec
from repro_torch.kernels import ops
from repro_torch.models import gan as tgan
from repro_torch.models import vision as tvision
from repro_torch.serve import conv_engine as teng
from repro_torch.serve import faults as tfaults
from repro_torch.serve.conv_graph import ConvGraph

Z_DIM, BASE = 8, 8
IMG = (8, 8, 3)
RUNGS = ("cuda", "torch_zero_free", "reference")


def _requests(mod, rng, kinds):
    return [mod.ConvRequest(None, kind, rng.standard_normal(
        (Z_DIM,) if kind == "gan_gen" else IMG).astype(np.float32))
        for kind in kinds]


@pytest.fixture(scope="module")
def jx():
    """`repro`'s modules and numpy params in `repro`'s layout."""
    import test_torch_serve as ts
    return ts, ts.jeng, ts._repro_tree(
        ts.jgan.generator_init, 0, z_dim=Z_DIM, base=BASE, out_ch=3), \
        ts._repro_tree(ts.jvision.atrous_head_init, 1, in_ch=3, width=4,
                       n_classes=4)


def test_the_cpu_engine_holds_no_graph_and_serves_as_repro(jx):
    from repro_torch.convert import params_from_numpy
    ts, jeng, gan_np, aspp_np = jx
    t = teng.ConvServeEngine(
        gan_params=params_from_numpy(gan_np, device="cpu"),
        aspp_params=params_from_numpy(aspp_np, device="cpu"),
        ladder=("cuda",), device="cpu", slot_batch=2, queue_limit=8)
    j = jeng.ConvServeEngine(gan_params=gan_np, aspp_params=aspp_np,
                             ladder=("xla_zero_free",), slot_batch=2,
                             queue_limit=8)
    kinds = ["gan_gen", "aspp", "gan_gen", "aspp", "gan_gen"]
    t.warmup([("gan_gen", (Z_DIM,)), ("aspp", IMG)], compile=True)
    for seed in (4, 5):          # a second serve on the same engine
        t_reqs = _requests(teng, np.random.default_rng(seed), kinds)
        j_reqs = _requests(jeng, np.random.default_rng(seed), kinds)
        t_res, j_res = t.serve(t_reqs), j.serve(j_reqs)
        assert len(t_res) == len(j_res) == len(kinds)
        for a, b in zip(t_reqs, j_reqs):
            assert_allclose(t_res[a.uid], j_res[b.uid], err_msg=a.kind)
    th, jh = t.health(), j.health()
    assert {k: th[k] for k in ts.STAT_KEYS} == \
        {k: jh[k] for k in ts.STAT_KEYS}
    assert th["captures"] == t.captures == 0
    assert t.graphs == {} and t.replay_launches == {}
    assert not any(t.graphed(r) for r in RUNGS)


def _inject_rung(name: str, base: str, injector):
    """`inject_backend(base)` registered under its `@inject` name."""
    be = tfaults.inject_backend(base, injector)
    assert be.name == name
    tspec.register_backend(be)
    return name


def test_an_inject_rung_stays_eager(monkeypatch):
    """On a card every rung but an `@inject` one is graphed; on the CPU
    the `@inject` rung serves with its per-op events firing on every
    launch (a replay would skip them), equal to its base rung."""
    monkeypatch.setattr(tspec, "_BACKENDS", dict(tspec._BACKENDS))
    inj = tfaults.FaultInjector(tfaults.FaultSchedule())
    rung = _inject_rung("torch_zero_free@inject", "torch_zero_free", inj)
    gp = tgan.generator_init(torch.Generator().manual_seed(3),
                             z_dim=Z_DIM, base=BASE, device="cpu")
    eng = teng.ConvServeEngine(gan_params=gp, slot_batch=2, device="cpu",
                               ladder=(rung,))
    base = teng.ConvServeEngine(gan_params=gp, slot_batch=2, device="cpu",
                                ladder=("torch_zero_free",))
    events = []
    for n in (2, 4):             # one launch, then two
        reqs = _requests(teng, np.random.default_rng(n), ["gan_gen"] * n)
        got = eng.serve(reqs)
        want = base.serve(_requests(teng, np.random.default_rng(n),
                                    ["gan_gen"] * n))
        for r, w in zip(reqs, sorted(want)):
            np.testing.assert_array_equal(got[r.uid], want[w])
        events.append(sum(inj._counters.values()))
    # the generator's three transposed convs consult the injector on every
    # launch: three launches in all, a third of the events in the first
    assert events[0] >= 3 and events[1] == 3 * events[0]
    assert eng.captures == 0 and eng.graphs == {}
    eng.device = torch.device("cuda")          # as the card's engine sees it
    assert not eng.graphed(rung)
    assert all(eng.graphed(r) for r in RUNGS)
    # the mark rides on the backend, and a ladder holding it inherits it
    assert not tspec.resolve_backend(rung).graphable
    assert not tspec.fallback_backend(
        ("cuda", tspec.resolve_backend(rung))).graphable
    assert tspec.fallback_backend(("cuda", "reference")).graphable


def test_a_conv_graph_runs_on_a_cuda_device_only():
    with pytest.raises(ValueError, match="CUDA device"):
        ConvGraph(lambda b: b, (2, Z_DIM), torch.device("cpu"), None)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_params(cuda):
    gen = torch.Generator().manual_seed(16)
    return (tgan.generator_init(gen, z_dim=Z_DIM, base=BASE, device=cuda),
            tvision.atrous_head_init(gen, in_ch=3, width=4, n_classes=4,
                                     device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("rung", RUNGS)
def test_every_bucket_replay_equals_its_eager_forward(cuda, rung,
                                                      monkeypatch):
    """Each bucket's first launch is eager and captured, its next three
    replays: each bit-equal to `forward_fn` run eagerly on the same
    batch on the graph's stream."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gp, ap = _card_params(cuda)
    eng = teng.ConvServeEngine(gan_params=gp, aspp_params=ap, slot_batch=2,
                               ladder=(rung,), device=cuda)
    rng = np.random.default_rng(8)
    for kind, shape in (("gan_gen", (Z_DIM,)), ("aspp", IMG)):
        bucket = eng._bucket(kind, shape)
        for i in range(4):
            batch = rng.standard_normal((2,) + shape).astype(np.float32)
            got = eng._forward(bucket, rung, batch)
            graph = eng.graphs[(bucket.key, rung)]
            graph.stream.wait_stream(torch.cuda.current_stream())
            with torch.no_grad(), torch.cuda.stream(graph.stream):
                want = eng.forward_fn(kind, rung)(
                    torch.from_numpy(batch).to(cuda))
            torch.cuda.current_stream().wait_stream(graph.stream)
            np.testing.assert_array_equal(got, want.cpu().numpy(),
                                          err_msg=f"{kind} launch {i}")
    assert eng.captures == 2 == eng.health()["captures"]


@pytest.mark.gpu
def test_replays_count_their_captures_launches(cuda):
    """Two serves of 6 requests per kind at slot batch 2: one capture per
    bucket, in the first; `ops.LAUNCHES` counts each bucket's eager
    launch and capture, `replay_launches` the capture's count once per
    later batch; the second serve captures nothing and answers the
    same."""
    gp, ap = _card_params(cuda)
    eng = teng.ConvServeEngine(gan_params=gp, aspp_params=ap, slot_batch=2,
                               device=cuda)
    kinds = ["gan_gen", "aspp"] * 6
    ops.reset_launches()
    first = eng.serve(_requests(teng, np.random.default_rng(9), kinds))
    counted = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert eng.captures == 2 and len(eng.graphs) == 2
    per_batch = {}
    for g in eng.graphs.values():
        for k, n in g.launches.items():
            per_batch[k] = per_batch.get(k, 0) + n
    assert per_batch.get("dconv_forward") == 3
    assert counted == {k: 2 * n for k, n in per_batch.items()}
    assert eng.replay_launches == {k: 2 * n for k, n in per_batch.items()}
    second = eng.serve(_requests(teng, np.random.default_rng(9), kinds))
    assert eng.captures == 2
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == counted
    assert eng.replay_launches == {k: 5 * n for k, n in per_batch.items()}
    for a, b in zip(sorted(first), sorted(second)):
        np.testing.assert_array_equal(first[a], second[b])
    assert eng.health()["captures"] == 2


@pytest.mark.gpu
def test_an_inject_rung_stays_eager_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(tspec, "_BACKENDS", dict(tspec._BACKENDS))
    inj = tfaults.FaultInjector(tfaults.FaultSchedule())
    rung = _inject_rung("cuda@inject", "cuda", inj)
    gp, _ = _card_params(cuda)
    eng = teng.ConvServeEngine(gan_params=gp, slot_batch=2, device=cuda,
                               ladder=(rung,))
    ops.reset_launches()
    with torch.no_grad():
        eng.forward_fn("gan_gen", "cuda")(torch.zeros((2, Z_DIM),
                                                      device=cuda))
    per_batch = sum(ops.LAUNCHES.values())
    ops.reset_launches()
    res = eng.serve(_requests(teng, np.random.default_rng(10),
                              ["gan_gen"] * 6))
    assert len(res) == 6 and eng.captures == 0 and eng.graphs == {}
    # every launch eager: three batches, the kernels' wrappers each time
    assert per_batch >= 3 and sum(ops.LAUNCHES.values()) == 3 * per_batch
