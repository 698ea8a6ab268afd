"""The moe, ssm, hybrid, audio and vlm families and the int8 KV cache on
a device mesh (A.12.1 / A.12.2) on the CPU, against `repro`.

  * Entry for entry, no spawn: the port's `tree_pspecs` equals `repro`'s
    for every SMOKE config in each of `tree_shardings`' layouts
    (training, serve, `moe_ffn_data`), and its `cache_pspecs` of each
    family's real cache (the int8 cache too) equals `repro`'s, on (2, 2)
    and (4, 2) ("data", "model") meshes (`repro`'s side on a
    `jax.sharding.AbstractMesh`).
  * On 4 `gloo` CPU ranks spawned once (`tests/_torch_mesh_families.py`),
    a (2, 2) mesh, each case's SMOKE config in fp32 on the same numpy
    params and batch as `repro` on one CPU device: qwen3-moe-235b-a22b
    (GQA, 2 kv heads), moonshot-v1-16b-a3b (shared experts), moonshot
    with `capacity_factor` 0.25 (its per-row groups and its decode
    batch's group drop tokens, which the test checks first), rwkv6-7b,
    zamba2-2.7b (2 groups: the shared block used twice), musicgen-medium
    and internvl2-76b (embeddings in), qwen3-0.6b with `kv_quant`; in the
    training and serve layouts, the MoE cases in `moe_ffn_data`'s too:
    the loss (1e-5 relative) and every gradient (1e-3 of each leaf's
    largest magnitude: `test_torch_mesh_lm.py`'s bounds), the prefill's
    and 4 forced decodes' logits and whole cache per call (1e-4; int8
    codes equal), each cache entry in `cache_pspecs`' layout;
    `make_train_step`'s loss and MoE aux on moonshot; and
    `ServeEngine(mesh=, serve_sharding="tp")`'s tokens for moonshot,
    rwkv6 and zamba2 equal `repro`'s engine's.
"""
from __future__ import annotations

import concurrent.futures
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import _torch_mesh_families
from conftest import assert_allclose
from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as jsteps
from repro.models.lm import LM as JLM
from repro.parallel import sharding as jsh
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.lm import LM as TLM
from repro_torch.parallel import sharding as sh

TOL, GRAD_TOL, LOSS_TOL = 1e-4, 1e-3, 1e-5
MAX_LEN, DECODES, PROMPT = 16, 4, 6      # decodes 3-4 in sequence block 1
BATCH, SEQ = 4, 20
ENGINE = [(5, 3), (3, 5), (4, 2)]        # (prompt length, new tokens)
# name -> (arch, overrides, layouts, decode batch, step, engine)
CASES = {
    "qwen3_moe": ("qwen3_moe_235b_a22b", {}, ("train", "tp", "ffn"), 4,
                  False, False),
    "moonshot": ("moonshot_v1_16b_a3b", {}, ("train", "tp", "ffn"), 4, True,
                 True),
    "moonshot_drop": ("moonshot_v1_16b_a3b", {"capacity_factor": 0.25},
                      ("train", "tp", "ffn"), 16, True, False),
    "rwkv6": ("rwkv6_7b", {}, ("train", "tp"), 4, False, True),
    "zamba2": ("zamba2_2_7b", {}, ("train", "tp"), 4, False, True),
    "musicgen": ("musicgen_medium", {}, ("train", "tp"), 4, False, False),
    "internvl2": ("internvl2_76b", {}, ("train", "tp"), 4, False, False),
    "qwen3_kv_quant": ("qwen3_0_6b", {"kv_quant": True}, ("train", "tp"), 4,
                       False, False),
}
LAYOUT_KW = {"train": {}, "tp": {"serve": True},
             "ffn": {"moe_ffn_data": True}}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _jcfg(name):
    arch, kw, *_ = CASES[name]
    return j_smoke(arch).scaled(dtype="float32", **kw)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _case_inputs(name, seed):
    import dataclasses
    arch, kw, layouts, dec_b, step, engine = CASES[name]
    jcfg = _jcfg(name)
    rng = np.random.default_rng(seed)
    V, D = jcfg.vocab, jcfg.d_model

    def tokens(b, s):
        return rng.integers(1, V, (b, s)).astype(np.int32)

    def embeds(b, s):
        return rng.standard_normal((b, s, D)).astype(np.float32)

    # The port's init draws the tree (repro's shapes and scales) without
    # a compile; both sides get the same numpy params.
    drawn = TLM(TConfig(**dataclasses.asdict(jcfg))).init(
        torch.Generator().manual_seed(seed), device="cpu")
    case = {"cfg": dataclasses.asdict(jcfg), "layouts": layouts,
            "params": _noisy(tL.tree_map(lambda t: t.numpy(), drawn),
                             seed + 1),
            "max_len": MAX_LEN, "step": step}
    labels = tokens(BATCH, SEQ)
    labels[0, :3] = -1
    case["labels"] = labels
    if jcfg.embed_input:
        case["inputs"], case["prompts"] = embeds(BATCH, SEQ), \
            embeds(dec_b, PROMPT)
    else:
        case["inputs"], case["prompts"] = tokens(BATCH, SEQ), \
            tokens(dec_b, PROMPT)
    case["forced"] = tokens(dec_b, DECODES)
    if engine:
        case["engine"] = [(rng.integers(1, V, p).astype(np.int32), n)
                          for p, n in ENGINE]
    return case


def _repro_side(case, jcfg):
    """`repro` on one CPU device: the loss and gradients, the prefill and
    each decode (logits and cache), the engine's tokens."""
    lm = JLM(jcfg)
    jp = jax.tree.map(jnp.asarray, case["params"])
    out = {"grads": jax.jit(jax.value_and_grad(
        lambda p: lm.loss(p, case["inputs"], case["labels"]),
        has_aux=True))(jp)}
    logits, cache = jax.jit(lambda p, x: lm.prefill(p, x, MAX_LEN))(
        jp, case["prompts"])
    calls = [(logits, cache)]
    decode = jax.jit(lm.decode_step)
    for i in range(DECODES):
        logits, cache = decode(jp, cache, case["forced"][:, i:i + 1])
        calls.append((logits, cache))
    out["calls"] = calls
    if "engine" in case:
        eng = JServeEngine(jcfg, jp, batch=2, max_len=MAX_LEN)
        out["tokens"] = eng.generate([
            JRequest(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(case["engine"])])
        out["stats"] = dict(eng.stats)
    return out


def _dropped(case):
    """Whether the port's routing on one device, on this case's params,
    sends a choice to the dump row in a training group (per batch row)
    and in a decode step's group (the batch)."""
    cfg = TConfig(**case["cfg"])
    lm = TLM(cfg)
    params = params_from_numpy(case["params"], device="cpu")
    seen = {"rows": False, "batch": False}
    real = tmoe.slots

    def spy(idx, cfg_, C):
        s = real(idx, cfg_, C)
        key = "batch" if idx.shape[0] == 1 and idx.shape[1] > 1 and \
            idx.shape[1] == case["forced"].shape[0] else "rows"
        seen[key] |= bool((s == cfg_.n_experts * C).any())
        return s

    tmoe.slots = spy
    try:
        with torch.no_grad():
            lm.loss(params, torch.from_numpy(case["inputs"]),
                    torch.from_numpy(case["labels"]))
            _, cache = lm.prefill(params, torch.from_numpy(case["prompts"]),
                                  MAX_LEN)
            lm.decode_step(params, cache,
                           torch.from_numpy(case["forced"][:, :1]))
    finally:
        tmoe.slots = real
    return seen


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, repro's results by case, every rank's results)."""
    tmp = str(tmp_path_factory.mktemp("mesh_families"))
    inp = {name: _case_inputs(name, 10 * i) for i, name in enumerate(CASES)}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    spawned = _torch_mesh_families.start(tmp)
    # XLA compiles outside the GIL: the cases' compiles overlap.
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        want = dict(zip(inp, pool.map(lambda n: _repro_side(inp[n],
                                                            _jcfg(n)), inp)))
    want["drops"] = _dropped(inp["moonshot_drop"])
    results = _torch_mesh_families.finish(spawned, tmp)
    return inp, want, results


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _tree_pairs(got, want):
    """(path, port leaf, repro leaf) in jax's leaf order."""
    got = tL.tree_paths(got)
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    return [(p, a, b) for (p, a), (_, b) in zip(got, ref)]


_RUNS = [(name, layout) for name, c in CASES.items() for layout in c[2]]


# -- entry for entry, no spawn -------------------------------------------------

def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jflat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return [[jsh._path_str(p), _entries(s)] for p, s in leaves]


def _tflat(specs, path=()):
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _tflat(specs[k], path + (str(k),))]
    return [["/".join(path), _entries(specs)]]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("layout", sorted(LAYOUT_KW))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_tree_pspecs_equal_repros(arch, layout, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    tmesh = _TAxes(shape, axes)
    jtree = jax.eval_shape(JLM(j_smoke(arch)).init, jax.random.PRNGKey(0))
    with torch.device("meta"):
        ttree = TLM(tconfigs.get_smoke_config(arch)).init_tree(
            torch.Generator())
    got = _tflat(sh.tree_pspecs(ttree, tmesh, **LAYOUT_KW[layout]))
    assert got == _jflat(jsh.tree_pspecs(jtree, jmesh, **LAYOUT_KW[layout]))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_pspecs_of_the_real_cache_equal_repros(arch, kv_quant,
                                                     mesh_name):
    shape, axes = MESHES[mesh_name]
    jcfg = j_smoke(arch).scaled(kv_quant=kv_quant)
    tcfg = tconfigs.get_smoke_config(arch).scaled(kv_quant=kv_quant)
    jcache = jax.eval_shape(lambda: JLM(jcfg).init_cache(8, 64))
    tcache = TLM(tcfg).init_cache(8, 64, device="meta")
    want = [e for e in _jflat(jsteps.cache_pspecs(jcache, AbstractMesh(
        shape, axes))) if e[0] != "len"]
    got = [e for e in _tflat({k: v for k, v in tsteps.cache_pspecs(
        tcache, _TAxes(shape, axes)).items() if k != "len"})]
    assert got == want
    assert sorted(tcache) == sorted(jcache)


class _TAxes:
    """A mesh's axis sizes and names alone: all the port's spec functions
    read (no process group behind it)."""

    def __init__(self, sizes, names):
        self.sizes, self.mesh_dim_names = tuple(sizes), tuple(names)

    def size(self, dim: int) -> int:
        return self.sizes[dim]


# -- every family on 4 ranks ---------------------------------------------------

def test_the_low_capacity_case_drops_tokens_in_both_groupings(run):
    """The training rows' groups and a decode step's batch group both
    send choices past their capacity, so a rank that routed only its own
    rows of a decode batch, or that counted the capacity per rank,
    would differ from `repro`."""
    _, want, _ = run
    assert want["drops"] == {"rows": True, "batch": True}


@pytest.mark.parametrize("name,layout", _RUNS)
def test_loss_and_every_gradient_match_repro(run, name, layout):
    _, want, results = run
    (jloss, jaux), jgrads = want[name]["grads"]
    for res in results:
        g = res[name][layout]
        assert abs(g["loss"] - float(jloss)) / abs(float(jloss)) < LOSS_TOL
        assert abs(g["aux"]["aux"] - float(jaux["aux"])) <= \
            LOSS_TOL * max(abs(float(jaux["aux"])), 1.0)
        for path, a, b in _tree_pairs(g["grads"], jgrads):
            b = _np(b)
            scale = float(np.abs(b).max()) or 1.0
            assert_allclose(_np(a), b, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                            err_msg=f"{name} {layout} {path}")


@pytest.mark.parametrize("name,layout", _RUNS)
def test_prefill_and_decodes_match_repro_per_call(run, name, layout):
    """Logits and every cache entry after the prefill and each decode;
    each entry laid out by `cache_pspecs` (batch over "data", the KV
    sequence and the SSM heads / conv channels over "model")."""
    inp, want, results = run
    cfg = TConfig(**inp[name]["cfg"])
    specs = tsteps.cache_pspecs(TLM(cfg).init_cache(
        inp[name]["prompts"].shape[0], MAX_LEN, device="meta"),
        _TAxes((2, 2), ("data", "model")))
    for res in results:
        s = res[name][layout]
        assert s["cache_specs"] == {k: v for k, v in specs.items()
                                    if k != "len"}
        for i, ((gl, gc), (wl, wc)) in enumerate(zip(s["calls"],
                                                     want[name]["calls"])):
            assert_allclose(_np(gl), _np(wl), rtol=TOL, atol=TOL,
                            err_msg=f"{name} {layout} logits {i}")
            assert gc["len"] == int(wc["len"]) == PROMPT + i
            assert sorted(gc) == sorted(wc)
            for k in gc:
                if k == "len":
                    continue
                a, b = gc[k], wc[k]
                if a.dtype == torch.int8:
                    np.testing.assert_array_equal(
                        a.numpy(), np.asarray(b), err_msg=f"{name} {k} {i}")
                else:
                    assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL,
                                    err_msg=f"{name} {layout} {k} {i}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]])
def test_train_step_carries_the_moe_aux(run, name):
    """`make_train_step` on the mesh: its loss is `repro`'s nll + 0.01 *
    aux, and its metrics carry the global aux loss (the product of the
    batch's two means, not a mean of the ranks' values)."""
    _, want, results = run
    (jloss, jaux), _ = want[name]["grads"]
    assert float(jaux["aux"]) > 0
    for res in results:
        m = res[name]["train"]["step"]
        assert abs(m["loss"] - float(jloss)) / abs(float(jloss)) < LOSS_TOL
        assert abs(m["aux"] - float(jaux["aux"])) / float(jaux["aux"]) < \
            LOSS_TOL
        assert abs(m["nll"] - float(jaux["nll"])) / float(jaux["nll"]) < \
            LOSS_TOL


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_engine_on_the_mesh_gives_repros_tokens(run, name):
    _, want, results = run
    for res in results:
        e = res[name]["engine"]
        assert e["tokens"] == want[name]["tokens"]
        assert e["stats"] == want[name]["stats"]
        assert e["stats"]["refills"] >= 1
