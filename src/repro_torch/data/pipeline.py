"""Deterministic synthetic batches for the conv training workloads (port
of `repro/data/pipeline.py::ConvDataset`).

Batch contents are a pure function of (seed, step): numpy's generator is
seeded from `SeedSequence([seed, step])` and draws in `repro`'s order, so
the port's batches are bit-identical to `repro`'s.  Batches are numpy
arrays, as in `repro`; the caller moves them to its device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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
