"""GAN training example, the paper's Sec. 6.3 evaluation domain
(counterpart of `examples/train_gan.py`).

The DCGAN-style generator upsamples with the zero-free transposed-conv
dataflow (its forward pass IS the paper's input-gradient dataflow); the
discriminator downsamples with stride-2 convs whose backward pass uses
the zero-free dataflows.  Alternating non-saturating updates on
synthetic blobs, each side with its own AdamW state.  On the `cuda`
backend the generator's layers are transposed-conv kernel launches with
relu / tanh in the epilogue, the discriminator's convs `dconv_forward`
launches with leaky_relu fused, and every conv VJP one fused backward
launch.  It runs eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_gan \\
          [--device cpu] [--steps 120]

Without `--device` it runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import gan
from repro_torch.models.layers import sgd_grads
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)

Z, BASE, BATCH = 32, 16, 16


def real_batch(step, *, batch=16, size=32):
    """Synthetic 'real' distribution, `repro`'s bit for bit: smooth
    low-frequency blobs in [-1, 1], (B, size, size, 3) fp32 on the CPU."""
    rng = np.random.default_rng(np.random.SeedSequence([11, step]))
    xy = np.linspace(-1, 1, size)
    gx, gy = np.meshgrid(xy, xy)
    imgs = []
    for _ in range(batch):
        cx, cy = rng.uniform(-0.5, 0.5, 2)
        s = rng.uniform(0.2, 0.5)
        img = np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / s)[..., None]
        imgs.append(np.repeat(img, 3, axis=-1) * 2 - 1)
    return torch.from_numpy(np.stack(imgs).astype(np.float32))


def noise(step, *, batch=BATCH, z_dim=Z):
    """The step's latent batch, `repro`'s bit for bit: (B, z_dim) fp32."""
    rng = np.random.default_rng(np.random.SeedSequence([3, step]))
    return torch.from_numpy(
        rng.standard_normal((batch, z_dim)).astype(np.float32))


def adamw_configs(steps: int):
    """(generator's, discriminator's) AdamW configs."""
    kw = dict(lr=2e-4, b1=0.5, warmup_steps=0, total_steps=steps,
              weight_decay=0.0)
    return AdamWConfig(**kw), AdamWConfig(**kw)


def make_step(gcfg: AdamWConfig, dcfg: AdamWConfig, *, backend="cuda"):
    """One alternating step: the discriminator's update, then the
    generator's against the updated discriminator.  (gp, dp, g_opt,
    d_opt, z, real) -> (gp, dp, g_opt, d_opt, g_loss, d_loss)."""
    def step(gp, dp, g_opt, d_opt, z, real):
        d_loss, d_grads = sgd_grads(
            lambda d: gan.gan_losses(gp, d, z, real, backend=backend)[1], dp)
        dp, d_opt, _ = adamw_update(d_grads, d_opt, dp, dcfg)
        g_loss, g_grads = sgd_grads(
            lambda g: gan.gan_losses(g, dp, z, real, backend=backend)[0], gp)
        gp, g_opt, _ = adamw_update(g_grads, g_opt, gp, gcfg)
        return gp, dp, g_opt, d_opt, g_loss, d_loss
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "torch_zero_free", "reference"),
                    help="conv dispatch backend (repro_torch.core.spec)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    gp = gan.generator_init(torch.Generator().manual_seed(0), z_dim=Z,
                            base=BASE, device=dev)
    dp = gan.discriminator_init(torch.Generator().manual_seed(1), base=BASE,
                                device=dev)
    gcfg, dcfg = adamw_configs(args.steps)
    g_opt, d_opt = adamw_init(gp, gcfg), adamw_init(dp, dcfg)
    step_fn = make_step(gcfg, dcfg, backend=args.backend)
    t0 = time.perf_counter()
    for step in range(args.steps):
        z = noise(step).to(dev)
        real = real_batch(step, batch=BATCH).to(dev)
        gp, dp, g_opt, d_opt, gl, dl = step_fn(gp, dp, g_opt, d_opt, z,
                                               real)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  g_loss {float(gl):.3f}  "
                  f"d_loss {float(dl):.3f}")
    with torch.no_grad():
        fake = gan.generator_apply(gp, z, backend=args.backend)
    print(f"\n{args.steps} alternating steps in {time.perf_counter() - t0:.1f}"
          f"s (backend={args.backend}, device={dev}); generator output "
          f"{tuple(fake.shape)}, range [{float(fake.min()):.2f}, "
          f"{float(fake.max()):.2f}]")
    assert np.isfinite(float(gl)) and np.isfinite(float(dl))
    return gp, dp


if __name__ == "__main__":
    main()
