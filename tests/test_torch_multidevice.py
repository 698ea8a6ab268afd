"""The port's conv path on a device mesh (`parallel/sharding.py`,
`launch/mesh.py`, `core.spec.dispatch_backend` / `sharded_backend`,
`fault_tolerance.elastic_mesh` / `survivors`, `ConvTrainer(mesh=...)`)
on the CPU, against `repro`.

  * Rules: `leaf_pspec` / `tree_pspecs` entries equal `repro`'s on the
    same (4, 2) ("data", "model") and (2, 2, 2) ("pod", "data", "model")
    meshes for the CNN and GAN trees and every LM SMOKE tree, with
    `serve` and `moe_ffn_data` (`repro`'s side runs once in a subprocess
    with 8 forced host devices); plus `repro`'s own asserts.
  * Elastic: `repro`'s `elastic_mesh` / `survivors` asserts, over ranks.
  * Sharded steps, on 4 `gloo` CPU ranks spawned once for the module
    (`tests/_torch_mesh.py`): the CNN, generator and GAN steps equal
    `repro`'s single-device step on the same numpy inputs (rtol 2e-4 /
    atol 2e-5, losses 1e-5, `repro`'s bounds); one conv layer launches
    one forward and one backward kernel per rank, on local shapes (batch
    / |data|, Cout / |model|); `ConvTrainer` restored from its (2, 2)
    checkpoint onto the elastic (1, 2) mesh ends where one rank alone
    ends.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh
from conftest import assert_allclose
from repro.models import cnn as jcnn
from repro.models import gan as jgan
from repro_torch import configs as tconfigs
from repro_torch.models import cnn as tcnn
from repro_torch.models import gan as tgan
from repro_torch.models.lm import LM as TLM
from repro_torch.parallel import sharding as sh
from repro_torch.train import fault_tolerance as ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RTOL, ATOL, LOSS_TOL = 2e-4, 2e-5, 1e-5


@dataclasses.dataclass(frozen=True)
class _Axes:
    """A mesh's axis sizes and names alone, all the rule functions read
    (`jax.sharding.AbstractMesh`): no process group behind it."""
    sizes: tuple
    mesh_dim_names: tuple

    def size(self, dim: int) -> int:
        return self.sizes[dim]


# -- rules --------------------------------------------------------------------

def _port_trees():
    """name -> the tree of shapes of every tree the rules are held on."""
    g = torch.Generator().manual_seed(0)
    trees = {"cnn": tcnn.simple_cnn_init(g, in_ch=3, widths=(32, 64, 128),
                                         n_classes=10, device="cpu"),
             "gen": tgan.generator_init(g, z_dim=64, base=64, device="cpu"),
             "disc": tgan.discriminator_init(g, in_ch=3, base=64,
                                             device="cpu")}
    for arch in tconfigs.ARCH_IDS:
        with torch.device("meta"):
            trees[arch] = TLM(tconfigs.get_smoke_config(arch)).init_tree(
                torch.Generator())
    return trees


_J_RULES = """
import json, jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import ARCH_IDS, get_smoke_config
from repro.models import cnn, gan
from repro.models.lm import LM
from repro.parallel import sharding as sh

trees = {"cnn": cnn.simple_cnn_init(jax.random.PRNGKey(0), in_ch=3,
                                    widths=(32, 64, 128), n_classes=10),
         "gen": gan.generator_init(jax.random.PRNGKey(1), z_dim=64, base=64),
         "disc": gan.discriminator_init(jax.random.PRNGKey(2), in_ch=3,
                                        base=64)}
for arch in ARCH_IDS:
    trees[arch] = jax.eval_shape(LM(get_smoke_config(arch)).init,
                                 jax.random.PRNGKey(0))
out = {}
for mname, (shape, axes) in MESHES.items():
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), axes)
    for name, tree in trees.items():
        for kw in ({}, {"serve": True}, {"moe_ffn_data": True}):
            specs = sh.tree_pspecs(tree, mesh, **kw)
            leaves = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))[0]
            out[f"{mname}|{name}|{sorted(kw)}"] = [
                [sh._path_str(p), [list(e) if isinstance(e, tuple) else e
                                   for e in s]] for p, s in leaves]
    out[f"{mname}|batch"] = [list(sh.batch_pspec(mesh, r, 0, n))
                             for r, n in ((4, 8), (4, None), (2, 6), (3, 16))]
print("RULES" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_rules():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"MESHES = {MESHES!r}\n" + textwrap.dedent(_J_RULES)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RULES")][0]
    return json.loads(line[len("RULES"):])


def _flat_specs(specs, path=()):
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _flat_specs(specs[k], path + (str(k),))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _flat_specs(v, path + (str(i),))]
    return [["/".join(path), [list(e) if isinstance(e, tuple) else e
                              for e in specs]]]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_tree_pspecs_equal_repros_entry_for_entry(repro_rules, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = _Axes(shape, axes)
    trees = _port_trees()
    for name, tree in trees.items():
        for kw in ({}, {"serve": True}, {"moe_ffn_data": True}):
            got = _flat_specs(sh.tree_pspecs(tree, mesh, **kw))
            assert got == repro_rules[f"{mesh_name}|{name}|{sorted(kw)}"], \
                (mesh_name, name, kw)
    assert [[list(e) if isinstance(e, tuple) else e
             for e in sh.batch_pspec(mesh, r, 0, n)]
            for r, n in ((4, 8), (4, None), (2, 6), (3, 16))] == \
        repro_rules[f"{mesh_name}|batch"]


def test_repros_rule_asserts_hold():
    """`repro`'s asserts of `tests/test_multidevice.py` (the name rules,
    the divisibility guard, the rank-4 conv-filter rule, `batch_pspec`'s
    size guard), entry for entry on the port."""
    mesh = _Axes((4, 2), ("data", "model"))
    assert sh.leaf_pspec("blocks/mlp/wi", (64, 128), mesh) == \
        ("data", "model")
    assert sh.leaf_pspec("blocks/mlp/wi", (63, 128), mesh) == \
        (None, "model")
    assert sh.leaf_pspec("blocks/moe/experts_wi", (8, 64, 128), mesh) == \
        ("model", "data", None)
    assert sh.leaf_pspec("embed/tok", (512, 64), mesh) == ("model", "data")
    assert sh.leaf_pspec("final_norm/scale", (64,), mesh) == (None,)
    assert sh.leaf_pspec("blocks/attn/wq", (2, 64, 128), mesh) == \
        (None, "data", "model")
    specs = sh.tree_pspecs(_port_trees()["cnn"], mesh)
    assert specs["convs"][0] == (None, None, None, "model")
    assert specs["convs"][1] == (None, None, "data", "model")
    assert specs["convs"][2] == (None, None, "data", "model")
    assert specs["head"] == ("data", "model")
    trees = _port_trees()
    gs, ds = sh.tree_pspecs(trees["gen"], mesh), \
        sh.tree_pspecs(trees["disc"], mesh)
    assert gs["t1"] == gs["t2"] == (None, None, "data", "model")
    assert gs["t3"] == (None, None, None, "model")
    assert ds["c2"] == (None, None, "data", "model")
    assert sh.tree_pspecs(trees["gen"], mesh, serve=True)["t1"] == \
        (None, None, None, ("model", "data"))
    assert sh.leaf_pspec("blocks/conv_w", (4, 64), mesh) == (None, "model")
    assert sh.batch_pspec(mesh, 4, 0, 8) == ("data", None, None, None)
    assert sh.batch_pspec(mesh, 4, 0, None) == (None,) * 4
    assert sh.batch_pspec(mesh, 2, 0, 6) == (None, None)


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Axes((2, 2, 2), ("pod", "data", "model"))
    assert sh.to_placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.to_placements(mesh, (None, None, None, None)) == \
        (Replicate(),) * 3
    # The serve layout's ("model", "data"): the same placements as the
    # mesh-order tuple (placements carry no order); the order stays in
    # the spec, which a DTensor cannot hold, so `device_put` keeps such a
    # leaf as a `Sharded`.
    assert sh.to_placements(mesh, (None, ("model", "data"))) == \
        sh.to_placements(mesh, (None, ("data", "model"))) == \
        (Replicate(), Shard(1), Shard(1))
    assert not sh.in_mesh_order(mesh, (None, ("model", "data")))


# -- elastic ------------------------------------------------------------------

@dataclasses.dataclass
class _Ranks:
    """A mesh's rank layout alone (what `survivors` reads)."""
    mesh: torch.Tensor


def test_elastic_layout_and_survivors_follow_repros_rules():
    """`repro`'s asserts over ranks: the model axis halves until it
    divides the survivors, every survivor is used, none left raises."""
    assert ft.elastic_layout(6, 16) == (3, 2)
    assert ft.elastic_layout(5, 4) == (5, 1)
    assert ft.elastic_layout(8, 4) == (2, 4)
    assert ft.elastic_layout(6, 64) == (3, 2)
    with pytest.raises(ValueError, match="no surviving"):
        ft.elastic_layout(0, 2)
    with pytest.raises(ValueError, match="no surviving"):
        ft.elastic_mesh([], model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="model_parallel"):
        ft.elastic_layout(4, 0)
    surv = ft.survivors(_Ranks(torch.arange(8).reshape(4, 2)), [0],
                        devices_per_host=2)
    assert surv == [2, 3, 4, 5, 6, 7]


def test_meshes_need_the_callers_process_group():
    from repro_torch.launch import mesh as tmesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_debug_mesh((1, 1), device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_production_mesh(device="cpu")


# -- sharded steps on 4 ranks -------------------------------------------------

def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, repro's single-device results, every rank's results)."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.default_rng(0)
    cp = _np(jcnn.simple_cnn_init(jax.random.PRNGKey(0), in_ch=3,
                                  widths=(8, 16), n_classes=10))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    gp = _np(jgan.generator_init(k1, z_dim=16, base=8, out_ch=3))
    dp = _np(jgan.discriminator_init(k2, in_ch=3, base=8))
    inp = {"cnn_w0": cp["convs"][0], "cnn_w1": cp["convs"][1],
           "cnn_head": cp["head"],
           "cnn_x": rng.normal(size=(8, 12, 12, 3)).astype(np.float32),
           "cnn_labels": rng.integers(0, 10, size=8).astype(np.int64),
           "z": rng.normal(size=(8, 16)).astype(np.float32),
           "real": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
           "l_x": rng.normal(size=(8, 10, 10, 4)).astype(np.float32),
           "l_w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
           "l_b": rng.normal(size=(8,)).astype(np.float32)}
    inp.update({"g_" + k: v for k, v in gp.items()})
    inp.update({"d_" + k: v for k, v in dp.items()})
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    spawned = _torch_mesh.start(tmp)

    # `repro`'s zero-free backend in XLA: the Pallas kernels in interpret
    # mode give the same steps (to 1e-9 at these shapes) at many times
    # the CPU time.
    kw = dict(backend="xla_zero_free", fuse_epilogue=True)
    jp = jax.tree.map(jnp.asarray, cp)
    want = {"cnn": jax.jit(lambda p: jcnn.sgd_step(
        p, inp["cnn_x"], inp["cnn_labels"].astype(np.int32), lr=0.05,
        stride=2, **kw))(jp)}
    jg, jd = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    want["gen"] = jax.jit(lambda g: jgan.gen_sgd_step(
        g, jd, inp["z"], lr=0.05, **kw))(jg)
    want["gan"] = jax.jit(lambda s: jgan.gan_sgd_step(
        s, inp["z"], inp["real"], lr=0.05, **kw))({"g": jg, "d": jd})
    return inp, want, _torch_mesh.finish(spawned, tmp)


def _tree_close(got, want):
    got = [np.asarray(t) for t in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), got,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))]
    want = [np.asarray(a) for a in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step", ["cnn", "gen", "gan"])
def test_sharded_step_matches_repros_single_device_step(ranks, step):
    _, want, results = ranks
    for res in results:    # every rank holds the same whole result
        got = res[step]
        _tree_close(got[0], want[step][0])
        for a, b in zip(got[1:], want[step][1:]):
            assert abs(a - float(b)) < LOSS_TOL, (step, a, float(b))


def test_one_conv_layer_launches_once_each_way_per_rank_on_local_shapes(
        ranks):
    """One forward and one backward kernel per rank (`repro`'s one
    pallas_call per shard), each given the rank's block: batch 8 / |data|
    = 4, Cin 4 whole (contracted, never sharded on the forward path),
    Cout 8 / |model| = 4; dx laid out as x, dW as w, db as b."""
    inp, _, results = ranks
    x = torch.from_numpy(inp["l_x"]).requires_grad_()
    w = torch.from_numpy(inp["l_w"]).requires_grad_()
    b = torch.from_numpy(inp["l_b"]).requires_grad_()
    from repro_torch.core.conv import ecoflow_conv
    from repro_torch.core.spec import Epilogue
    y = ecoflow_conv(x, w, 2, 1, "cuda", bias=b,
                     epilogue=Epilogue(activation="relu", bias=True))
    want = torch.autograd.grad(y.sum(), [x, w, b])
    for res in results:
        layer = res["layer"]
        assert layer["launches"] == {"dconv_forward": 1, "conv_backward": 1}
        for name, xs, dys, ws in layer["shapes"]:
            assert xs == (4, 10, 10, 4), (name, xs)
            assert ws == (3, 3, 4, 4), (name, ws)
            if dys is not None:
                assert dys == (4, 5, 5, 4), (name, dys)
        for a, b_ in zip(layer["grads"], want):
            assert_allclose(a, b_, rtol=1e-5, atol=1e-5)
        assert layer["placements"] == [
            "(Shard(dim=0), Replicate())", "(Shard(dim=2), Shard(dim=3))",
            "(Replicate(), Replicate())"]


def test_conv_trainer_restores_onto_the_elastic_mesh(ranks):
    """Host 1 (ranks 2, 3) is lost at step 2: `survivors` keeps ranks
    0, 1, `elastic_mesh` builds a (1, 2) mesh of them, the trainer
    restores the (2, 2) mesh's step-2 checkpoint onto it and runs to
    step 4, ending where one rank alone ends."""
    _, _, results = ranks
    alone = results[0]["alone"]
    for rank, res in enumerate(results):
        if rank >= 2:
            assert "elastic" not in res
            continue
        el = res["elastic"]
        assert el["ranks"] == [0, 1]
        assert el["shape"] == (1, 2) and el["names"] == ("data", "model")
        assert el["start"] == 2 and el["history"] == [3, 4]
        for a, b in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), el["state"],
                is_leaf=lambda t: isinstance(t, torch.Tensor))),
                jax.tree.leaves(jax.tree.map(
                    lambda t: t.numpy(), alone,
                    is_leaf=lambda t: isinstance(t, torch.Tensor)))):
            assert_allclose(a, b, rtol=RTOL, atol=ATOL)
