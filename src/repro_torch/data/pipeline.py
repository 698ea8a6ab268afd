"""Deterministic data streams (port of `repro/data/pipeline.py`): the LM's
token batches (`TokenDataset`, synthetic or from a memory-mapped token
file), the conv training workloads' batches (`ConvDataset`), and a
bounded background `Prefetcher`.

Batch contents are a pure function of (seed, step): numpy's generator is
seeded from `SeedSequence([seed, step])` and draws in `repro`'s order, so
the port's batches are bit-identical to `repro`'s, and a restart skips
ahead for free.  Batches are numpy arrays, as in `repro`; the caller (or
the prefetcher's `put` hook) moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class TokenDataset:
    """Deterministic token stream.  Synthetic by default, or backed by a
    memory-mapped uint32 token file."""

    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, token_file: Optional[str] = None,
                 embed_dim: Optional[int] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.embed_dim = embed_dim
        self._tokens = None
        if token_file is not None:
            self._tokens = np.memmap(token_file, dtype=np.uint32, mode="r")

    def batch(self, step: int) -> dict:
        """{"labels", "inputs"} for a global step -- pure function of
        (seed, step).  inputs are the tokens (B,S) int32, or with
        `embed_dim` (the audio / vlm stub frontends) (B,S,embed_dim) fp32
        embeddings; labels the next tokens (B,S) int32."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S = self.global_batch, self.seq_len
        if self._tokens is not None:
            n = len(self._tokens) - (S + 1)
            starts = rng.integers(0, n, size=B)
            toks = np.stack([self._tokens[s:s + S + 1] for s in starts])
            toks = toks.astype(np.int32)
        else:
            toks = rng.integers(0, self.vocab, size=(B, S + 1),
                                dtype=np.int32)
        out = {"labels": toks[:, 1:]}
        if self.embed_dim is not None:
            out["inputs"] = rng.standard_normal(
                (B, S, self.embed_dim)).astype(np.float32)
        else:
            out["inputs"] = toks[:, :-1]
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class ConvDataset:
    """kind "cnn"     -> {"x": (B,H,W,C) f32, "labels": (B,) i32}
    kind "gan_gen" -> {"z": (B,z_dim) f32}
    kind "gan"     -> {"z": (B,z_dim) f32, "real": (B,32,32,C) f32}
    (the GAN "real" side is 32x32 -- the generator ladder's fixed output
    geometry, models/gan.py GENERATOR_LAYERS)."""

    def __init__(self, *, kind: str, batch: int, image: int = 12,
                 channels: int = 3, n_classes: int = 10, z_dim: int = 16,
                 seed: int = 0):
        if kind not in ("cnn", "gan", "gan_gen"):
            raise ValueError(f"unknown conv workload kind {kind!r}")
        self.kind = kind
        self.batch = batch
        self.image = image
        self.channels = channels
        self.n_classes = n_classes
        self.z_dim = z_dim
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        """Batch for a global step -- pure function of (seed, step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B = self.batch
        if self.kind == "cnn":
            return {"x": rng.standard_normal(
                        (B, self.image, self.image, self.channels)
                    ).astype(np.float32),
                    "labels": rng.integers(0, self.n_classes, size=B,
                                           dtype=np.int32)}
        out = {"z": rng.standard_normal((B, self.z_dim)).astype(np.float32)}
        if self.kind == "gan":
            out["real"] = rng.standard_normal(
                (B, 32, 32, self.channels)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of `dataset.iterate(start_step)` into a
    queue of at most `depth` batches, each passed through `put` first
    (the trainer's moves it to the card).  `next()` yields batches in step
    order; `close()` stops the thread.  An exception in the thread (a
    failed copy to the card) is handed on and raised by the `next()` that
    would have returned its batch, rather than leaving the consumer
    waiting on an empty queue."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2,
                 put=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._put = put or (lambda x: x)

        def worker():
            try:
                for batch in dataset.iterate(start_step):
                    if self._stop.is_set():
                        return
                    self._q.put(self._put(batch))
            except BaseException as e:   # noqa: BLE001 - re-raised in next()
                self._q.put(_Failed(e))

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Failed):
            raise RuntimeError("the prefetch thread failed") from item.error
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=60)


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error
