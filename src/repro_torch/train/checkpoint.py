"""Checkpointing: atomic, manifest-driven, async (port of
`repro/train/checkpoint.py`, in the same on-disk format).

Layout:  <dir>/step_<N>/
           manifest.json          {step, treedef, leaves: [{i, shape, dtype}]}
           leaf_<i>.npy           one array per tree leaf
         <dir>/LATEST             atomic pointer file

Leaves are numbered in `jax.tree_util.tree_flatten`'s order (dict keys
sorted, then sequences in order; `models.layers.tree_paths`), and the
manifest's `treedef` is the string jax prints for the same structure, so
`repro` restores the port's checkpoints and the port restores `repro`'s.

  * atomic:  writes go to step_<N>.tmp then os.replace -- a crash
    mid-save never corrupts the latest checkpoint.
  * async:   `AsyncCheckpointer.save_async` copies every leaf to host
    memory BEFORE it hands the write to a thread.  On the card the
    trainer's state lives in buffers that the next step overwrites in
    place, so a snapshot taken later would be torn (`repro`'s arrays are
    immutable and never had this hazard).
  * restore: each leaf is cast to the dtype of the matching leaf of
    `like` and placed on its device, or with `shardings` (a tree of
    `parallel.sharding.NamedSharding`) laid out on their mesh: leaves
    are saved whole, so a checkpoint written on one mesh restores onto
    any other.
  * bounded: keep_last prunes old steps, counting intact steps only.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_paths


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def treedef_str(tree) -> str:
    """The structure of `tree` as `str(jax.tree_util.tree_structure)`
    prints it, e.g. "PyTreeDef({'convs': [*, *], 'head': *})"."""
    def fmt(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _unflatten(like, leaves):
    """`like`'s structure (its dict key order kept) filled from the
    iterator `leaves`, which runs in sorted-key order."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3):
    """Synchronous atomic save of a tree of tensors or arrays."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "treedef": treedef_str(tree), "leaves": []}
    for i, (_, leaf) in enumerate(tree_paths(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        meta["leaves"].append({"i": i, "shape": list(arr.shape),
                               "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep_last)


def _prune(ckpt_dir: str, keep_last: int):
    """Drop old steps, counting `keep_last` over INTACT steps only: torn
    newer directories (a crashed async write, a truncated copy) must not
    push the newest restorable checkpoint out of the retention window."""
    if not keep_last:
        return
    steps = sorted(available_steps(ckpt_dir))
    intact = [s for s in steps if step_intact(ckpt_dir, s)]
    keep = set(intact[-keep_last:])
    for s in steps:
        if s in keep or s > min(keep, default=-1):
            # Torn steps newer than the oldest kept intact step stay too:
            # they may still be mid-write by a concurrent saver.
            continue
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def available_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return out


def step_intact(ckpt_dir: str, step: int) -> bool:
    """True when step_<N> is fully readable: the manifest parses with
    its expected keys and every leaf file loads with the recorded shape.
    A checkpoint written through `save` always passes (the directory is
    published atomically); a torn copy, a partially-deleted step, or a
    leaf truncated by a disk-full crash fails."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    try:
        with open(os.path.join(final, "manifest.json")) as f:
            meta = json.load(f)
        leaves = meta["leaves"]
        for i, rec in enumerate(leaves):
            arr = np.load(os.path.join(final, f"leaf_{i}.npy"),
                          allow_pickle=False)
            if tuple(arr.shape) != tuple(rec["shape"]):
                return False
    except Exception:   # noqa: BLE001 - any unreadability means corrupt
        return False
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest INTACT step.  The LATEST pointer is consulted first, but a
    corrupt (or stale) candidate is skipped with a `RuntimeWarning` and
    the next-newest intact step is returned instead: a restart resumes
    from the best usable state, never crashes on a torn file, and never
    silently trains from scratch."""
    candidates = sorted(available_steps(ckpt_dir), reverse=True)
    path = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(path):
        try:
            with open(path) as f:
                pointed = int(f.read().strip())
            candidates = [pointed] + [s for s in candidates if s != pointed]
        except (OSError, ValueError):
            warnings.warn(
                f"unreadable LATEST pointer in {ckpt_dir}; falling back "
                f"to the newest intact step directory",
                RuntimeWarning, stacklevel=2)
    for s in candidates:
        if step_intact(ckpt_dir, s):
            return s
        warnings.warn(
            f"checkpoint step_{s} in {ckpt_dir} is truncated or "
            f"partially written; skipping it for the newest intact step",
            RuntimeWarning, stacklevel=2)
    return None


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any = None, *,
            fallback: bool = True):
    """Restore into the structure of `like`, a tree of tensors (their
    global shapes): each leaf is cast to the dtype of `like`'s leaf and
    placed on its device, then laid out by the matching leaf of
    `shardings` when it is given (mesh-resharding restore: every rank
    reads the whole leaf and keeps its block).

    A truncated or partially-written step_<N> is skipped with a
    `RuntimeWarning` and the newest intact EARLIER step restores instead
    (`fallback=False` raises `RuntimeError` for callers that need the
    exact step).  With no intact step at all, `FileNotFoundError`."""
    if not step_intact(ckpt_dir, step):
        if not fallback:
            raise RuntimeError(
                f"checkpoint step_{step} in {ckpt_dir} is truncated or "
                f"partially written and fallback is disabled")
        intact = [s for s in sorted(available_steps(ckpt_dir))
                  if s != step and step_intact(ckpt_dir, s)]
        if not intact:
            raise FileNotFoundError(
                f"checkpoint step_{step} in {ckpt_dir} is corrupt and no "
                f"intact step exists to fall back to")
        warnings.warn(
            f"checkpoint step_{step} in {ckpt_dir} is truncated or "
            f"partially written; restoring newest intact step_{intact[-1]} "
            f"instead", RuntimeWarning, stacklevel=2)
        step = intact[-1]
    final = os.path.join(ckpt_dir, f"step_{step}")
    out = []
    for i, (_, ref) in enumerate(tree_paths(like)):
        arr = np.load(os.path.join(final, f"leaf_{i}.npy"),
                      allow_pickle=False)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: ckpt {arr.shape} vs expected {tuple(ref.shape)}")
        out.append(torch.from_numpy(arr).to(device=ref.device,
                                            dtype=ref.dtype))
    tree = _unflatten(like, iter(out))
    if shardings is not None:
        from repro_torch.parallel.sharding import device_put
        tree = device_put(tree, shardings)
    return tree


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background
    thread.

    A failure in the background write (disk full, permission flip, torn
    filesystem) is NOT swallowed: it is captured and re-raised on the
    next `wait()` / `save_async()`, so the trainer finds out a
    checkpoint it believes exists was never published, while the step
    that overlapped the write still completes."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write to {self.ckpt_dir} failed"
            ) from err

    def save_async(self, step: int, tree: Any):
        self.wait()
        # Synchronous copy of every leaf to host memory: the caller may
        # overwrite its tensors (the next step's commit) right after.
        host = _unflatten(tree, iter(_host(leaf)
                                     for _, leaf in tree_paths(tree)))

        # ... asynchronous disk write; exceptions are parked for the
        # next wait()/save_async() instead of dying with the thread.
        def _write():
            try:
                save(self.ckpt_dir, step, host, keep_last=self.keep_last)
            except BaseException as e:   # noqa: BLE001 - must propagate
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
