"""The port's checkpoints (`repro_torch.train.checkpoint`) against
`repro`'s: the same files both ways, bit-equal, on the CNN and GAN
training trees, and the format's policies -- a torn step falling back
with a RuntimeWarning, keep_last over intact steps, the async writer's
error re-raise and its host snapshot, the dtype cast on restore.

Both packages' trees come from the same numpy arrays; comparisons are
exact (np.testing.assert_array_equal), as a checkpoint moves bits.
"""
from __future__ import annotations

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.convert import params_from_numpy
from repro_torch.models.layers import tree_map, tree_paths
from repro_torch.train import checkpoint as tckpt


def _cnn_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"head": rng.standard_normal((16, 4)).astype(np.float32),
            "convs": [rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
                      rng.standard_normal((3, 3, 8, 16)).astype(np.float32)]}


def _gan_tree(seed=1):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    # Keys stored out of sorted order: the leaf numbering must sort them.
    return {"g": {"t3": w(4, 4, 3, 2), "proj": w(8, 64), "t1": w(4, 4, 4, 8),
                  "t2": w(4, 4, 2, 4)},
            "d": {"head": w(128, 1), "c1": w(4, 4, 3, 2),
                  "c3": w(4, 4, 4, 8), "c2": w(4, 4, 2, 4)}}


TREES = {"cnn": _cnn_tree, "gan": _gan_tree}


def _assert_same(port_tree, want_np):
    got = [(p, t.numpy()) for p, t in tree_paths(port_tree)]
    want = jax.tree_util.tree_flatten_with_path(want_np)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kind", sorted(TREES))
def test_tree_paths_and_treedef_follow_jax(kind):
    tree = TREES[kind]()
    assert [p for p, _ in tree_paths(tree)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tckpt.treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    odd = {"b": (1, [2, ()]), "a": (3,), "c": {}}
    assert tckpt.treedef_str(odd) == str(jax.tree_util.tree_structure(odd))


@pytest.mark.parametrize("kind", sorted(TREES))
def test_repro_saves_the_port_restores(tmp_path, kind):
    tree = TREES[kind]()
    jckpt.save(str(tmp_path), 3, tree)
    like = tree_map(torch.zeros_like, params_from_numpy(tree, "cpu"))
    assert tckpt.latest_step(str(tmp_path)) == 3
    out = tckpt.restore(str(tmp_path), 3, like)
    assert list(out) == list(like)            # the caller's key order
    _assert_same(out, tree)


@pytest.mark.parametrize("kind", sorted(TREES))
def test_the_port_saves_repro_restores(tmp_path, kind):
    tree = TREES[kind]()
    tckpt.save(str(tmp_path), 5, params_from_numpy(tree, "cpu"))
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    assert jckpt.latest_step(str(tmp_path)) == 5
    out = jckpt.restore(str(tmp_path), 5, like)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        out, tree)
    # The same manifest as repro's own save of the same tree.
    jckpt.save(str(tmp_path / "j"), 5, tree)
    with open(tmp_path / "step_5" / "manifest.json") as f:
        got = json.load(f)
    with open(tmp_path / "j" / "step_5" / "manifest.json") as f:
        want = json.load(f)
    assert got == want


def _tear(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step}", "leaf_0.npy"),
              "r+b") as f:
        f.truncate(8)


def test_torn_step_falls_back_with_a_warning(tmp_path):
    d = str(tmp_path)
    tree = params_from_numpy(_cnn_tree(), "cpu")
    tckpt.save(d, 2, tree)
    tckpt.save(d, 4, tree_map(lambda t: t + 1, tree))
    _tear(d, 4)
    assert not tckpt.step_intact(d, 4) and tckpt.step_intact(d, 2)
    with pytest.warns(RuntimeWarning):
        assert tckpt.latest_step(d) == 2
    with pytest.warns(RuntimeWarning, match="restoring newest intact"):
        out = tckpt.restore(d, 4, tree)
    _assert_same(out, _cnn_tree())
    with pytest.raises(RuntimeError, match="fallback is disabled"):
        tckpt.restore(d, 4, tree, fallback=False)
    _tear(d, 2)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, 4, tree)


def test_prune_counts_keep_last_over_intact_steps(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(4)}
    for s in (2, 4, 6):
        tckpt.save(d, s, tree, keep_last=0)      # no pruning yet
    _tear(d, 6)
    tckpt._prune(d, keep_last=1)
    # the newest INTACT step survives; the torn-but-newer step_6 stays
    # too (it may be a concurrent mid-write); only step_2 is pruned
    assert sorted(tckpt.available_steps(d)) == [4, 6]
    with pytest.warns(RuntimeWarning):
        assert tckpt.latest_step(d) == 4
    for s in (8, 10):
        tckpt.save(d, s, tree, keep_last=2)
    assert sorted(tckpt.available_steps(d)) == [8, 10]


def test_restore_casts_to_the_like_dtype(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 1, {"w": np.arange(6, dtype=np.float64).reshape(2, 3)})
    out = tckpt.restore(d, 1, {"w": torch.zeros(2, 3)})
    assert out["w"].dtype == torch.float32
    np.testing.assert_array_equal(out["w"].numpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(ValueError, match="leaf 0"):
        tckpt.restore(d, 1, {"w": torch.zeros(3, 2)})


def test_async_checkpointer_reraises_background_failure(tmp_path,
                                                        monkeypatch):
    acp = tckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save", boom)
    acp.save_async(1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        acp.wait()
    acp.wait()              # the error is consumed
    acp.save_async(2, {"w": torch.zeros(2)})
    # save_async joins the previous write first, so a parked error
    # surfaces at the next save rather than being overwritten
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        acp.save_async(3, {"w": torch.zeros(2)})
    monkeypatch.undo()
    acp.save_async(4, {"w": torch.zeros(2)})
    acp.wait()
    assert tckpt.latest_step(str(tmp_path)) == 4


def test_async_checkpointer_snapshots_before_the_thread(tmp_path,
                                                        monkeypatch):
    """The state is overwritten in place right after save_async (as the
    card's step buffers are by the next commit): the file must hold the
    values at the call."""
    gate = threading.Event()
    real_save = tckpt.save

    def slow_save(*a, **kw):
        assert gate.wait(timeout=30)
        real_save(*a, **kw)

    monkeypatch.setattr(tckpt, "save", slow_save)
    tree = params_from_numpy(_gan_tree(), "cpu")
    acp = tckpt.AsyncCheckpointer(str(tmp_path))
    acp.save_async(7, tree)
    for _, leaf in tree_paths(tree):
        leaf.fill_(float("nan"))
    gate.set()
    acp.wait()
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), _gan_tree())
    out = jckpt.restore(str(tmp_path), 7, like)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        out, _gan_tree())
