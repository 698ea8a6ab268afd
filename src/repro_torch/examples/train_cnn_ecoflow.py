"""End-to-end example: train a CNN classifier with EcoFlow backward passes
(counterpart of `examples/train_cnn_ecoflow.py`).

The paper's headline workload is CNN training on a spatial accelerator;
here every convolution's backward pass routes through the zero-free
transposed (input-grad) and dilated (filter-grad) dataflows.  An
AllConvNet-style model (stride-2 convs instead of pooling, the paper's
Sec. 6.1.1 optimization) trains on synthetic stripe images with AdamW.
On the `cuda` backend each conv's forward is one `dconv_forward` launch
with its relu in the epilogue and each conv's backward one
`conv_backward` launch.  A step is the loss's gradients, an AdamW update,
then the updated model's logits for the accuracy; it runs eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_cnn_ecoflow \\
          [--device cpu] [--steps 300]

Without `--device` it runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.models.layers import sgd_grads
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)

WIDTHS = (16, 32, 64)
N_CLASSES = 10


def synth_batch(step: int, *, batch=32, size=24, n_classes=N_CLASSES):
    """Deterministic synthetic 'shapes' set, `repro`'s bit for bit: class =
    dominant stripe frequency, a pure function of `step`.  (images (B,
    size, size, 3) fp32, labels (B,) int32) on the CPU."""
    rng = np.random.default_rng(np.random.SeedSequence([7, step]))
    y = rng.integers(0, n_classes, batch)
    xs = []
    for i in range(batch):
        freq = 1 + y[i]
        t = np.linspace(0, np.pi * freq, size)
        img = np.outer(np.sin(t), np.cos(t))[..., None]
        img = np.repeat(img, 3, axis=-1)
        img += 0.35 * rng.standard_normal((size, size, 3))
        xs.append(img)
    return (torch.from_numpy(np.stack(xs).astype(np.float32)),
            torch.from_numpy(y.astype(np.int32)))


def make_step(ocfg: AdamWConfig, *, backend="cuda"):
    """The training step: (params, opt, images, labels) -> (params, opt,
    loss, accuracy), the last two 0-d tensors on the params' device."""
    def step(params, opt, x, y):
        loss, grads = sgd_grads(
            lambda p: cnn.cnn_loss(p, x, y, stride=2, backend=backend),
            params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        with torch.no_grad():
            logits = cnn.simple_cnn_apply(params, x, stride=2,
                                          backend=backend)
        acc = (torch.argmax(logits, -1) == y).to(torch.float32).mean()
        return params, opt, loss, acc
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "torch_zero_free", "reference"),
                    help="conv dispatch backend (repro_torch.core.spec)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params = cnn.simple_cnn_init(torch.Generator().manual_seed(0),
                                 widths=WIDTHS, n_classes=N_CLASSES,
                                 device=dev)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                       weight_decay=0.01)
    opt = adamw_init(params, ocfg)
    step_fn = make_step(ocfg, backend=args.backend)
    t0 = time.perf_counter()
    for step in range(args.steps):
        x, y = synth_batch(step)
        params, opt, loss, acc = step_fn(params, opt, x.to(dev), y.to(dev))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"acc {float(acc):.2f}")
    dt = time.perf_counter() - t0
    print(f"\ntrained {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.1f} it/s, backend={args.backend}, "
          f"device={dev}); final train acc {float(acc):.2f}")
    assert float(acc) > 0.5, "training should beat chance comfortably"
    return params


if __name__ == "__main__":
    main()
