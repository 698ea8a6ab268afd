"""End-to-end example: train the atrous segmentation head with zero-free
dilated convolutions (counterpart of `examples/segment_atrous.py`).

The segmentation workload the paper motivates (Sec. 1): DeepLab's atrous
convs apply the filter at rate D without losing resolution.  Every
branch routes through `ecoflow_dilated_conv`, so the dilated filter is
never materialized, forward or backward.  On the `cuda` backend each
branch's forward is one `dconv_forward` launch with its relu in the
epilogue and each conv's backward one `conv_backward` launch;
`--no-fuse-epilogue` runs the relu tails as separate ops.  A step is the
loss's gradients, an AdamW update, then the updated head's logits for
the pixel accuracy; it runs eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.segment_atrous \
          [--device cpu] [--steps 120]

Without `--device` it runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import vision
from repro_torch.models.layers import sgd_grads
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)

RATES = (1, 2, 4)


def synth_batch(step: int, *, batch=8, size=24):
    """Deterministic synthetic segmentation set, `repro`'s bit for bit:
    each image carries a bright axis-aligned rectangle on textured noise;
    the per-pixel label is 1 inside the rectangle, else 0.  A pure
    function of `step`: (images (B, size, size, 3) fp32, labels (B, size,
    size) int32) on the CPU."""
    rng = np.random.default_rng(np.random.SeedSequence([11, step]))
    xs, ys = [], []
    for _ in range(batch):
        img = 0.3 * rng.standard_normal((size, size, 3))
        y = np.zeros((size, size), np.int32)
        r0, c0 = rng.integers(2, size - 10, 2)
        h, w = rng.integers(6, 10, 2)
        img[r0:r0 + h, c0:c0 + w] += 1.5
        y[r0:r0 + h, c0:c0 + w] = 1
        xs.append(img)
        ys.append(y)
    return (torch.from_numpy(np.stack(xs).astype(np.float32)),
            torch.from_numpy(np.stack(ys)))


def make_step(ocfg: AdamWConfig, *, rates=RATES, backend="cuda",
              fuse_epilogue=True):
    """The training step: (params, opt, images, labels) -> (params, opt,
    loss, pixel accuracy), the last two 0-d tensors on the params'
    device."""
    def step(params, opt, x, y):
        loss, grads = sgd_grads(
            lambda p: vision.atrous_seg_loss(
                p, x, y, rates=rates, backend=backend,
                fuse_epilogue=fuse_epilogue), params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        with torch.no_grad():
            logits = vision.atrous_head_apply(
                params, x, rates=rates, backend=backend,
                fuse_epilogue=fuse_epilogue)
        acc = (torch.argmax(logits, -1) == y).to(torch.float32).mean()
        return params, opt, loss, acc
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "torch_zero_free", "reference"),
                    help="conv dispatch backend (repro_torch.core.spec)")
    ap.add_argument("--no-fuse-epilogue", dest="fuse_epilogue",
                    action="store_false",
                    help="run the branch relu tails as separate ops "
                         "instead of the fused epilogue slot")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params = vision.atrous_head_init(torch.Generator().manual_seed(0),
                                     in_ch=3, width=16, n_classes=2,
                                     rates=RATES, device=dev)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                       weight_decay=0.01)
    opt = adamw_init(params, ocfg)
    step_fn = make_step(ocfg, backend=args.backend,
                        fuse_epilogue=args.fuse_epilogue)
    t0 = time.perf_counter()
    for step in range(args.steps):
        x, y = synth_batch(step)
        params, opt, loss, acc = step_fn(params, opt, x.to(dev), y.to(dev))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"pixel-acc {float(acc):.3f}")
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({1e3 * dt / args.steps:.1f} ms/step, backend={args.backend}, "
          f"device={dev})")
    return params


if __name__ == "__main__":
    main()
