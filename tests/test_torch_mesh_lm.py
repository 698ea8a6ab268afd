"""The dense LM on a device mesh (A.12's LM half) on the CPU, against
`repro`: `parallel/sharding.py`'s LM layouts, the mesh paths of
`models/layers.py` and `models/lm.py`, `launch/steps.py`'s abstract
inputs, sharding trees and train step, `Trainer(mesh=)`,
`ServeEngine(mesh=)`, `parallel/pipeline.py::gpipe`,
`parallel/compression.py` and `train/supervisor.py::RunSupervisor`.

  * Entry for entry: `input_specs` (shapes, dtypes), `cache_pspecs`,
    `batch_shardings`, `abstract_state` and `effective_microbatches`
    with a mesh equal `repro`'s for every SMOKE config on a (4, 2)
    ("data", "model") and a (2, 2, 2) ("pod", "data", "model") mesh;
    `repro`'s serve and cache asserts (`tests/test_multidevice.py:
    240-270`); and every rank's block of each serve-layout ("model",
    "data") leaf equals the slice jax gives the same device.  `repro`'s
    side runs once in a subprocess with 8 forced host devices, which
    also runs `repro`'s `gpipe`, `compressed_psum` and `RunSupervisor`
    on the same inputs.
  * On 4 `gloo` CPU ranks spawned once (`tests/_torch_mesh_lm.py`), a
    (2, 2) mesh: `make_train_step` (n_micro 1, 2) equals `repro`'s
    single-device `jax.jit(make_train_step)` (loss 1e-3 relative,
    params rtol = atol = 2e-2: `tests/test_multidevice.py:67-108`'s
    bounds), the loss and every gradient too (1e-3 of each leaf's
    largest magnitude); prefill and 8 forced decodes in the training and
    the serve layout equal `repro`'s `LM.prefill` / `decode_step` per
    call (logits and cache, 1e-4, fp32), the first three decodes with no
    live key on the second sequence block; `ServeEngine(mesh=)` gives
    `repro`'s tokens; `Trainer(mesh=)` restores `repro`'s step-2
    checkpoint onto the elastic (1, 2) mesh bit for bit and runs on to
    `repro`'s step 4; `gpipe` equals the sequential stages and
    `repro`'s; `compressed_psum` equals `repro`'s; `RunSupervisor`'s
    report has `repro`'s keys and meshes, and its final state equals
    the fault-free run's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_lm
from conftest import assert_allclose
from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch.mesh import make_debug_mesh
from repro.models.lm import LM as JLM
from repro.optim import optimizer as jopt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL
from repro_torch.models.config import ShapeConfig as TShape
from repro_torch.parallel import sharding as sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = {"train": (32, 8), "prefill": (32, 8), "decode": (64, 8)}
MB_CASES = [(8, 4), (8, 3), (6, 4), (16, 4), (4, 8)]   # (batch, microbatch)
OPT = dict(lr=3e-3, warmup_steps=0, total_steps=10, eps=1e-6)
TRAINER_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=4)
MAX_LEN, DECODES = 16, 8
TOL, GRAD_TOL, LOSS_TOL, PARAM_TOL = 1e-4, 1e-3, 1e-3, 2e-2


@dataclasses.dataclass(frozen=True)
class _Axes:
    """A mesh's axis sizes and names alone (`jax.sharding.AbstractMesh`):
    all the spec functions read."""
    sizes: tuple
    mesh_dim_names: tuple

    def size(self, dim: int) -> int:
        return self.sizes[dim]


def _cfg(arch, **kw):
    jcfg = j_smoke(arch).scaled(**kw)
    return jcfg, dataclasses.asdict(jcfg)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, path=()):
    """[(path, leaf)] in sorted-key order (jax's); a tuple (a spec) is a
    leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (str(i),))]
    return [("/".join(path), tree)]


# -- repro's side, in a subprocess with 8 host devices -----------------------

_J_SIDE = """
import json, pickle, tempfile, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import ARCH_IDS, get_smoke_config
from repro.launch import steps
from repro.models.config import ShapeConfig
from repro.optim.optimizer import AdamWConfig
from repro.parallel import sharding as sh
from repro.parallel.compression import compressed_psum
from repro.parallel.pipeline import gpipe
from repro.train.conv_trainer import ConvTrainer, ConvTrainerConfig
from repro.train.supervisor import RunSupervisor

inp = pickle.load(open(INPUTS, "rb"))
out = {}

def paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, (P, NamedSharding)))[0]
    return [[sh._path_str(p), l] for p, l in leaves]

def ent(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

for mname, (shape, axes) in MESHES.items():
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), axes)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        for kind, (S, B) in CELLS.items():
            cell = ShapeConfig(kind, S, B, kind)
            specs = steps.input_specs(cfg, cell)
            out[f"{mname}|{arch}|{kind}|inputs"] = [
                [p, list(l.shape), str(l.dtype)] for p, l in paths(specs)]
            bs = steps.batch_shardings(cfg, cell, mesh)
            out[f"{mname}|{arch}|{kind}|batch"] = [
                [p, ent(l.spec)] for p, l in paths(bs)]
            if kind == "decode":
                out[f"{mname}|{arch}|cache"] = [
                    [p, ent(s)] for p, s in
                    paths(steps.cache_pspecs(specs["cache"], mesh))]
        params, opt = steps.abstract_state(cfg, AdamWConfig())
        out[f"{arch}|state"] = [[p, list(l.shape), str(l.dtype)]
                                for p, l in paths({"p": params, "o": opt})]
        out[f"{mname}|{arch}|micro"] = [
            steps.effective_microbatches(cfg.scaled(microbatch=m), b, mesh)
            for b, m in MB_CASES]

# the serve layout's blocks: the slice of each leaf each device holds
mesh4 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
shapes = {p: l.shape for p, l in paths(jax.tree.map(np.asarray, inp["arange_np"]))}
tree = jax.tree.map(np.asarray, inp["arange_np"])
shard = sh.tree_shardings(tree, mesh4, serve=True)
blocks = {}
for p, ns in paths(shard):
    idx = ns.devices_indices_map(shapes[p])
    blocks[p] = {str(d.id): [[s.start or 0, s.stop if s.stop is not None
                              else n] for s, n in zip(idx[d], shapes[p])]
                 for d in idx}
out["serve_blocks"] = blocks

# gpipe and compressed_psum on the same inputs
stage = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("stage",))
ws, x = jnp.asarray(inp["gp_w"]), jnp.asarray(inp["gp_x"])
out["gpipe"] = np.asarray(gpipe(stage, "stage", lambda w, h: jnp.tanh(h @ w),
                                ws, x, x.shape[0])).tolist()
pod = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
g = jnp.asarray(inp["cp_g"])
f = shard_map(lambda gg, ee: compressed_psum(gg, "pod", ee), mesh=pod,
              in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")))
red, err = f(g, jnp.zeros_like(g))
out["compressed"] = [np.asarray(red).tolist(), np.asarray(err).tolist()]

# RunSupervisor: 4 devices, 2 a host, host 1 lost at step 3
cfg = dict(workload="cnn", total_steps=6, widths=[4], image=8, n_classes=4,
           batch=8, backend="xla_zero_free", ckpt_every=2, seed=0)
with tempfile.TemporaryDirectory() as d:
    rep = RunSupervisor(ConvTrainerConfig(**cfg, ckpt_dir=d),
                        devices=jax.devices()[:4], devices_per_host=2,
                        model_parallel=2, host_schedule={3: [1]}).run()
r = rep["report"]
out["supervisor"] = {"keys": sorted(r), "guard_keys": sorted(r["guard"]),
                     "meshes": r["meshes"], "host_losses": r["host_losses"],
                     "recompiles": r["recompiles"],
                     "steps_lost": r["steps_lost"],
                     "recoveries": r["recoveries"],
                     "history": [h["step"] for h in rep["history"]]}
print("JSIDE" + json.dumps(out))
"""


def _inputs(tmp):
    """The numpy inputs of both sides, pickled to tmp/inputs.pkl."""
    jcfg, fields = _cfg("qwen3_0_6b", dtype="float32")
    params = _noisy(JLM(jcfg).init(jax.random.PRNGKey(0)), 1)
    b = jpipe.TokenDataset(vocab=jcfg.vocab, seq_len=24, global_batch=8,
                           seed=5).batch(0)
    labels = b["labels"].copy()
    labels[0, :5] = -1
    labels[-1, -3:] = -1
    rng = np.random.default_rng(3)
    ecfg, efields = _cfg("qwen2_1_5b", dtype="float32", tie_embeddings=False)
    eparams = _noisy(JLM(ecfg).init(jax.random.PRNGKey(2)), 4)
    tcfg, tfields = _cfg("qwen3_0_6b", dtype="float32", microbatch=1)
    with torch.device("meta"):
        like = tsteps.LM(tconfigs.get_smoke_config("qwen3_0_6b")).init_tree(
            torch.Generator())
    arange = tL.tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float32)
                         .reshape(t.shape), like)
    inp = {"cfg": fields, "opt": OPT, "params": params,
           "inputs": b["inputs"], "labels": labels,
           "prompts": rng.integers(1, jcfg.vocab, (4, 5)).astype(np.int32),
           "forced": rng.integers(1, jcfg.vocab, (4, DECODES))
           .astype(np.int32), "max_len": MAX_LEN,
           "engine_cfg": efields, "engine_params": eparams,
           "engine_prompts": [rng.integers(1, 512, n).astype(np.int32)
                              for n in (3, 5, 2, 4)],
           "engine_budgets": [2, 6, 3, 4],
           "trainer": {"cfg": tfields, "opt": TRAINER_OPT,
                       "vocab": tcfg.vocab, "seq_len": 32, "batch": 4},
           "arange": arange,
           "arange_np": tL.tree_map(lambda t: t.numpy(), arange),
           "gp_w": (rng.normal(size=(4, 16, 16)) / 4).astype(np.float32),
           "gp_x": rng.normal(size=(8, 2, 16)).astype(np.float32),
           "cp_g": rng.normal(size=(2, 64)).astype(np.float32)}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, repro's single-device results, repro's subprocess side,
    every rank's results)."""
    tmp = str(tmp_path_factory.mktemp("mesh_lm"))
    inp = _inputs(tmp)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"INPUTS = {os.path.join(tmp, 'inputs.pkl')!r}\n"
            f"MESHES = {MESHES!r}\nCELLS = {CELLS!r}\n"
            f"MB_CASES = {MB_CASES!r}\n" + textwrap.dedent(_J_SIDE))
    jside = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    spawned = _torch_mesh_lm.start(tmp)

    # repro's Trainer writes the checkpoint the ranks restore.
    t = inp["trainer"]
    jcfg = j_smoke("qwen3_0_6b").scaled(dtype="float32", microbatch=1)
    ds = jpipe.TokenDataset(vocab=t["vocab"], seq_len=t["seq_len"],
                            global_batch=t["batch"], seed=0)
    ckpt_dir = os.path.join(tmp, "repro_ckpt")
    want = {"trainer": jtrainer.Trainer(
        jcfg, make_debug_mesh(), ds, jopt.AdamWConfig(**TRAINER_OPT),
        jtrainer.TrainerConfig(total_steps=4, ckpt_dir=ckpt_dir,
                               ckpt_every=2, log_every=1,
                               async_checkpoint=False)).run()}
    open(os.path.join(ckpt_dir, "READY"), "w").close()
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        {"params": want["trainer"]["params"],
                         "opt": want["trainer"]["opt"]})
    want["ckpt_2"] = jckpt.restore(ckpt_dir, 2, like)

    jcfg = j_smoke("qwen3_0_6b").scaled(dtype="float32")
    jp = jax.tree.map(jnp.asarray, inp["params"])
    jo = jopt.AdamWConfig(**OPT)
    batch = {"inputs": inp["inputs"], "labels": inp["labels"]}
    for n_micro in (1, 2):
        want[f"step_{n_micro}"] = jax.jit(jsteps.make_train_step(
            jcfg, jo, n_micro))(jp, jopt.adamw_init(jp, jo), batch)
    lm = JLM(jcfg)
    want["forward"] = jax.jit(lm.forward)(jp, inp["inputs"])[0]
    want["grads"] = jax.jit(jax.value_and_grad(
        lambda p: lm.loss(p, inp["inputs"], inp["labels"]), has_aux=True))(jp)
    logits, cache = jax.jit(lambda p, x: lm.prefill(p, x, MAX_LEN))(
        jp, inp["prompts"])
    calls = [(logits, cache["k"], cache["v"])]
    decode = jax.jit(lm.decode_step)
    for i in range(DECODES):
        logits, cache = decode(jp, cache, inp["forced"][:, i:i + 1])
        calls.append((logits, cache["k"], cache["v"]))
    want["calls"] = calls
    ecfg = j_smoke("qwen2_1_5b").scaled(dtype="float32",
                                        tie_embeddings=False)
    eng = JServeEngine(ecfg, jax.tree.map(jnp.asarray, inp["engine_params"]),
                       batch=2, max_len=48)
    want["tokens"] = eng.generate([
        JRequest(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in
        enumerate(zip(inp["engine_prompts"], inp["engine_budgets"]))])
    want["stats"] = dict(eng.stats)

    results = _torch_mesh_lm.finish(spawned, tmp)
    stdout, stderr = jside.communicate(timeout=600)
    assert jside.returncode == 0, stderr
    line = [ln for ln in stdout.splitlines() if ln.startswith("JSIDE")][0]
    return inp, want, json.loads(line[len("JSIDE"):]), results


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _tree_pairs(got, want):
    """(path, port leaf, repro leaf) in jax's leaf order."""
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    return [(p, a, b) for (p, a), (_, b) in zip(got, ref)]


# -- entry for entry ----------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_and_abstract_inputs_equal_repros(run, mesh_name):
    _, _, jside, _ = run
    shape, axes = MESHES[mesh_name]
    mesh = _Axes(shape, axes)
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_smoke_config(arch)
        for kind, (S, B) in CELLS.items():
            cell = TShape(kind, S, B, kind)
            specs = tsteps.input_specs(cfg, cell)
            got = [[p, list(leaf.shape), str(leaf.dtype).split(".")[-1]]
                   for p, leaf in _flat(specs)
                   if not (p.endswith("len") and isinstance(leaf, int))]
            want = [e for e in jside[f"{mesh_name}|{arch}|{kind}|inputs"]
                    if not e[0].endswith("len")]
            assert got == want, (arch, kind)
            bs = tsteps.batch_shardings(cfg, cell, mesh)
            got = [[p, _entries(ns.spec)] for p, ns in _flat(bs)]
            assert got == jside[f"{mesh_name}|{arch}|{kind}|batch"], \
                (arch, kind)
            if kind == "decode":
                assert specs["cache"]["len"] == 0
                got = [[p, _entries(s)] for p, s in _flat(
                    tsteps.cache_pspecs(specs["cache"], mesh))]
                assert got == jside[f"{mesh_name}|{arch}|cache"], arch
        assert [tsteps.effective_microbatches(cfg.scaled(microbatch=m), b,
                                              mesh)
                for b, m in MB_CASES] == jside[f"{mesh_name}|{arch}|micro"]
        params, opt = tsteps.abstract_state(cfg, tsteps.AdamWConfig())
        got = [[p, list(leaf.shape), str(leaf.dtype).split(".")[-1]]
               for p, leaf in _flat({"p": params, "o": opt})]
        assert got == jside[f"{arch}|state"], arch
        assert all(leaf.device.type == "meta"
                   for leaf in tL.tree_leaves(params))


def test_repros_serve_and_cache_asserts_hold():
    """`tests/test_multidevice.py:240-270` on the port."""
    mesh = _Axes((4, 2), ("data", "model"))
    assert sh.leaf_pspec("blocks/mlp/wi", (64, 128), mesh, serve=True) == \
        (None, ("model", "data"))
    assert sh.leaf_pspec("blocks/mlp/wo", (128, 64), mesh, serve=True) == \
        (("model", "data"), None)
    assert sh.leaf_pspec("blocks/moe/experts_wi", (8, 64, 128), mesh,
                         serve=True) == ("model", None, "data")
    assert sh.leaf_pspec("blocks/moe/experts_wi", (8, 64, 128), mesh,
                         moe_ffn_data=True) == ("model", None, "data")
    with torch.device("meta"):
        cache = {"k": torch.empty((2, 8, 64, 4, 16), dtype=torch.bfloat16),
                 "v": torch.empty((2, 8, 64, 4, 16), dtype=torch.bfloat16),
                 "len": 0}
    specs = tsteps.cache_pspecs(cache, mesh)
    assert specs["k"] == (None, "data", "model", None, None)
    assert specs["len"] == ()


def test_serve_layout_blocks_follow_the_tuples_order(run):
    """Each rank's block of every serve-layout leaf is the slice jax puts
    on the same device of a (2, 2) mesh: a ("model", "data") dim's
    blocks go model-outer, not in the mesh's order."""
    inp, _, jside, results = run
    shapes = {p: tuple(t.shape) for p, t in _flat(inp["arange"])}
    for rank, res in enumerate(results):
        for layout in ("train", "tp"):      # laid out the same in both runs
            for p, blk in _flat(res[f"serve_{layout}"]["serve_blocks"]):
                want = jside["serve_blocks"][p][str(rank)]
                start = np.unravel_index(int(blk.flatten()[0]), shapes[p])
                got = [[int(s), int(s) + n] for s, n in zip(start,
                                                            blk.shape)]
                assert got == want, (rank, p)
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Axes((2, 2), ("data", "model"))
    assert sh.to_placements(mesh, (None, ("model", "data"))) == \
        sh.to_placements(mesh, (None, ("data", "model"))) == \
        (Shard(1), Shard(1))
    assert sh.to_placements(mesh, ("model", None)) == (Replicate(), Shard(0))
    assert not sh.in_mesh_order(mesh, (None, ("model", "data")))
    assert sh.in_mesh_order(mesh, (("data", "model"), None))


# -- the LM on 4 ranks --------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_sharded_train_step_matches_repros_single_device(run, n_micro):
    _, want, _, results = run
    jp, jstate, jm = want[f"step_{n_micro}"]
    for res in results:
        got = res[f"step_{n_micro}"]
        la, lb = got["metrics"]["loss"], float(jm["loss"])
        assert abs(la - lb) / max(abs(lb), 1.0) < LOSS_TOL, (la, lb)
        for path, a, b in _tree_pairs(got["params"], jp):
            assert_allclose(_np(a), _np(b), rtol=PARAM_TOL, atol=PARAM_TOL,
                            err_msg=path)
        for path, a, b in _tree_pairs(got["opt"], jstate):
            assert_allclose(_np(a), _np(b), rtol=PARAM_TOL, atol=PARAM_TOL,
                            err_msg=path)
        # The params keep their layout: FSDP x TP blocks, DTensors.
        assert "(Shard(dim=1), Shard(dim=2))" in got["placements"]


def test_sharded_loss_and_every_gradient_match_repro(run):
    _, want, _, results = run
    (jloss, jaux), jgrads = want["grads"]
    for res in results:
        g = res["grads"]
        assert abs(g["loss"] - float(jloss)) / abs(float(jloss)) < 1e-5
        for path, a, b in _tree_pairs(g["grads"], jgrads):
            b = _np(b)
            scale = float(np.abs(b).max()) or 1.0
            assert_allclose(_np(a), b, rtol=GRAD_TOL,
                            atol=GRAD_TOL * scale, err_msg=path)


def test_sharded_forward_gives_each_rank_its_batch_block(run):
    """`LM.forward` on the mesh: this rank's rows (8 / |data|) of the
    hidden states `repro`'s forward gives."""
    _, want, _, results = run
    for res in results:
        d = res["coord"][0]
        assert_allclose(_np(res["forward"]),
                        _np(want["forward"])[4 * d:4 * (d + 1)], rtol=TOL,
                        atol=TOL)


def test_each_rank_attends_over_its_heads_once_per_layer(run):
    """The training step: one attention call per layer per forward (remat
    runs each forward twice), on this rank's batch block (8 / |data|) and
    heads (4 / |model| query, 2 / |model| kv heads)."""
    inp, _, _, results = run
    cfg = inp["cfg"]
    for res in results:
        seen = res["step_1"]["attention"]
        assert len(seen) == 2 * cfg["n_layers"]
        assert {s[:2] for s in seen} == {((4, 24, 2, 16), (4, 24, 1, 16))}


@pytest.mark.parametrize("layout", ["train", "tp"])
def test_prefill_and_decode_match_repro_per_call(run, layout):
    """Logits and the whole cache after the prefill and each decode.  The
    cache is (L, B, 16, Hk, D) over (data, model) on (batch, sequence):
    the second sequence block holds positions 8-15, so through the first
    three decodes (positions 5-7) its ranks have no live key and make no
    attention call."""
    inp, want, _, results = run
    for rank, res in enumerate(results):
        s = res[f"serve_{layout}"]
        assert s["cache_spec"] == (None, "data", "model", None, None)
        assert s["cache_block"] == (2, 2, MAX_LEN // 2, 1 * 2, 16)
        for i, ((gl, gk, gv), (wl, wk, wv)) in enumerate(
                zip(s["calls"], want["calls"])):
            assert_allclose(_np(gl), _np(wl), rtol=TOL, atol=TOL,
                            err_msg=f"logits {i}")
            assert_allclose(_np(gk), _np(wk), rtol=TOL, atol=TOL,
                            err_msg=f"k {i}")
            assert_allclose(_np(gv), _np(wv), rtol=TOL, atol=TOL,
                            err_msg=f"v {i}")
        decodes = [a for a in s["attention"] if a[2]]
        second = res["coord"][1] == 1
        lens = [k[1] for _, k, _ in decodes]
        want_lens = [min(max(p + 1 - 8, 0), 8) if second else min(p + 1, 8)
                     for p in range(5, 5 + DECODES)]
        assert lens == [n for n in want_lens
                        for _ in range(inp["cfg"]["n_layers"]) if n]


@pytest.mark.parametrize("layout", ["train", "tp"])
def test_engine_on_the_mesh_gives_repros_tokens(run, layout):
    _, want, _, results = run
    for res in results:
        s = res[f"serve_{layout}"]
        assert s["tokens"] == want["tokens"]
        assert s["stats"] == want["stats"]
        assert s["stats"]["refills"] >= 2


def test_trainer_restores_repros_checkpoint_onto_the_elastic_mesh(run):
    """Host 1 (ranks 2, 3) lost: ranks 0 and 1 form the (1, 2) mesh,
    restore `repro`'s step-2 checkpoint bit for bit (whole leaves laid
    out on the new mesh) and train on to `repro`'s step 4."""
    _, want, _, results = run
    jrun = want["trainer"]
    for rank, res in enumerate(results):
        if rank >= 2:
            assert "trainer" not in res
            continue
        t = res["trainer"]
        assert t["ranks"] == [0, 1] and t["shape"] == (1, 2)
        assert t["restored"]["step"] == 2
        for path, a, b in _tree_pairs(
                {"opt": t["restored"]["opt"],
                 "params": t["restored"]["params"]}, want["ckpt_2"]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
        assert [h["step"] for h in t["history"]] == [3, 4]
        for a, b in zip([h["loss"] for h in t["history"]],
                        [h["loss"] for h in jrun["history"][2:]]):
            assert abs(a - b) / abs(b) < LOSS_TOL, (a, b)
        for path, a, b in _tree_pairs(t["params"], jrun["params"]):
            assert_allclose(_np(a), _np(b), rtol=PARAM_TOL, atol=PARAM_TOL,
                            err_msg=path)


def test_gpipe_matches_sequential_stages_and_repro(run):
    inp, _, jside, results = run
    ref = inp["gp_x"]
    for s in range(4):
        ref = np.tanh(ref @ inp["gp_w"][s])
    for res in results:
        for key in ("gpipe", "gpipe_split"):
            assert_allclose(res[key].numpy(), ref, rtol=1e-5, atol=1e-5)
            assert_allclose(res[key].numpy(), np.asarray(jside["gpipe"]),
                            rtol=1e-5, atol=1e-5)


def test_compressed_psum_equals_repros(run):
    """Each pod's ranks hold that pod's gradient; every rank gets
    `repro`'s mean of the dequantized values, and its pod's error."""
    inp, _, jside, results = run
    red, err = (np.asarray(a) for a in jside["compressed"])
    for rank, res in enumerate(results):
        pod = rank // 2
        out, e = res["compressed"]
        assert_allclose(out.numpy(), red[pod], rtol=1e-6, atol=1e-6)
        assert_allclose(e.numpy(), err[pod], rtol=1e-6, atol=1e-6)
        assert_allclose(out.numpy(), inp["cp_g"].mean(0), rtol=0.15,
                        atol=0.05)
        grads, errors = res["compressed_tree"]
        assert torch.equal(grads["a"], out) and torch.equal(errors["a"], e)
        assert grads["b"][0].shape == (8,)


def test_supervisor_shrinks_like_repros_and_ends_where_the_fault_free_run_does(
        run):
    _, _, jside, results = run
    jsup = jside["supervisor"]
    assert jsup["meshes"] == [{"data": 2, "model": 2},
                              {"data": 1, "model": 2}]
    for rank, res in enumerate(results):
        s = res["supervisor"]
        rep = s["report"]
        assert sorted(rep) == jsup["keys"]
        assert sorted(rep["guard"]) == jsup["guard_keys"]
        if rank >= 2:      # host 1: its processes left the run
            assert s["lost"] and not s["group"]
            continue
        assert rep["meshes"] == jsup["meshes"]
        for k in ("host_losses", "recompiles", "steps_lost", "recoveries"):
            assert rep[k] == jsup[k], k
        assert s["history"] == jsup["history"] and s["world"] == 2
        for a, b in zip(tL.tree_leaves(s["state"]),
                        tL.tree_leaves(results[0]["fault_free"])):
            assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
