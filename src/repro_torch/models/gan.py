"""DCGAN-style generator and discriminator (port of
`repro/models/gan.py`), the paper's GAN evaluation domain.

The generator upsamples with `ecoflow_conv_transpose`: the paper's
zero-free transposed-conv dataflow is its forward pass.  The
discriminator downsamples with strided `ecoflow_conv`, whose backward is
zero-free.  Each layer's relu / tanh / leaky_relu tail rides in the
conv's epilogue slot.  The training steps are functional, as in `repro`:
state in, new state and losses out.

Mesh-aware like `models/cnn.py`: under `parallel.sharding.use_mesh` the
convs run per shard, the latent and image batches are laid out over the
data axes, and the dense projection, the discriminator's head and the
losses run on the global batch on every rank (`sharding.unshard`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.conv import ecoflow_conv, ecoflow_conv_transpose
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.device import resolve_device
from repro_torch.models.layers import (sgd_grads, sgd_update,
                                       tree_all_finite, trunc_normal)
from repro_torch.parallel.sharding import shard, unshard

_RELU = Epilogue(activation="relu")
_TANH = Epilogue(activation="tanh")
_LEAKY = Epilogue(activation="leaky_relu", slope=0.2)

# The upsampling ladder: (param name, tconv-input spatial size, output
# spatial size, fused epilogue).  `generator_apply` and
# `generator_plan_requests` both read it, so the serving buckets plan
# exactly the launches the forward pass makes.
GENERATOR_LAYERS = (("t1", (4, 4), (8, 8), _RELU),
                    ("t2", (8, 8), (16, 16), _RELU),
                    ("t3", (16, 16), (32, 32), _TANH))


def generator_init(generator: torch.Generator, *, z_dim=64, base=64,
                   out_ch=3, device=None) -> dict:
    """Random generator params, `repro`'s shapes and scales.  Conv filters
    are stored in direct-conv orientation (K, K, Cin, Cout) where Cin is
    the upsampled (output) side."""
    dev = resolve_device(device)

    def w(k, cin, cout):
        return trunc_normal(generator, (k, k, cin, cout),
                             1.0 / math.sqrt(k * k * cin))

    params = {
        "proj": trunc_normal(generator, (z_dim, 4 * 4 * base * 2),
                              1.0 / math.sqrt(z_dim)),
        "t1": w(4, base, base * 2),      # 4x4 -> 8x8
        "t2": w(4, base // 2, base),     # 8x8 -> 16x16
        "t3": w(4, out_ch, base // 2),   # 16x16 -> 32x32
    }
    return {k: v.to(dev) for k, v in params.items()}


def generator_apply(params: dict, z: torch.Tensor, *, backend=None,
                    fuse_epilogue=True) -> torch.Tensor:
    """z (B, z_dim) -> images (B, 32, 32, out_ch) in [-1, 1].
    `fuse_epilogue` requests each layer's relu/tanh tail through the
    transposed conv's epilogue slot; False keeps separate activation ops
    for A/B comparison."""
    B = z.shape[0]
    x = torch.relu(torch.matmul(unshard(z), unshard(params["proj"]))
                   .reshape(B, 4, 4, -1))
    for name, _, out_hw, ep in GENERATOR_LAYERS:
        if fuse_epilogue:
            x = ecoflow_conv_transpose(x, params[name], 2, 1, n_out=out_hw,
                                       backend=backend, epilogue=ep)
        else:
            x = ecoflow_conv_transpose(x, params[name], 2, 1, n_out=out_hw,
                                       backend=backend)
            x = torch.tanh(x) if ep.activation == "tanh" else torch.relu(x)
    return x


def generator_plan_requests(params: dict, batch: int, *,
                            fuse_epilogue=True) -> list:
    """One `("input_grad", spec, x_shape, dy_shape, epilogue)` entry per
    transposed-conv layer of one serving bucket (epilogue None without
    `fuse_epilogue`).  `x_shape` is the upsampled OUTPUT side and
    `dy_shape` the tconv input, matching the input-gradient formulation
    the filters are stored in."""
    entries = []
    for name, in_hw, out_hw, ep in GENERATOR_LAYERS:
        w = params[name]
        spec = ConvSpec.make(stride=2, padding=1,
                             filter_shape=tuple(w.shape[:2]))
        entries.append(("input_grad", spec,
                        (batch, out_hw[0], out_hw[1], int(w.shape[2])),
                        (batch, in_hw[0], in_hw[1], int(w.shape[3])),
                        ep if fuse_epilogue else None))
    return entries


def discriminator_init(generator: torch.Generator, *, in_ch=3, base=64,
                       device=None) -> dict:
    """Random discriminator params, `repro`'s shapes and scales."""
    dev = resolve_device(device)

    def w(k, cin, cout):
        return trunc_normal(generator, (k, k, cin, cout),
                            1.0 / math.sqrt(k * k * cin))

    params = {
        "c1": w(4, in_ch, base // 2),
        "c2": w(4, base // 2, base),
        "c3": w(4, base, base * 2),
        "head": trunc_normal(generator, (4 * 4 * base * 2, 1),
                             1.0 / math.sqrt(4 * 4 * base * 2)),
    }
    return {k: v.to(dev) for k, v in params.items()}


def discriminator_apply(params: dict, x: torch.Tensor, *, backend=None,
                        fuse_epilogue=True) -> torch.Tensor:
    """images (B, 32, 32, C) -> logits (B, 1): three K=4, S=2, P=1 convs
    (32 -> 16 -> 8 -> 4) with leaky_relu(0.2), then a linear head."""
    for name in ("c1", "c2", "c3"):
        if fuse_epilogue:   # leaky_relu(0.2) fused into each conv launch
            x = ecoflow_conv(x, params[name], 2, 1, backend, epilogue=_LEAKY)
        else:
            x = F.leaky_relu(ecoflow_conv(x, params[name], 2, 1, backend),
                             0.2)
    x = unshard(x)
    return torch.matmul(x.reshape(x.shape[0], -1), unshard(params["head"]))


def gan_losses(g_params: dict, d_params: dict, z: torch.Tensor,
               real: torch.Tensor, *, backend=None, fuse_epilogue=True):
    """Non-saturating GAN losses (g_loss, d_loss)."""
    fake = generator_apply(g_params, z, backend=backend,
                           fuse_epilogue=fuse_epilogue)
    d_fake = discriminator_apply(d_params, fake, backend=backend,
                                 fuse_epilogue=fuse_epilogue)
    d_real = discriminator_apply(d_params, real, backend=backend,
                                 fuse_epilogue=fuse_epilogue)
    d_loss = F.softplus(-d_real).mean() + F.softplus(d_fake).mean()
    return F.softplus(-d_fake).mean(), d_loss


def _g_loss(g_params, d_params, z, backend, fuse_epilogue):
    fake = generator_apply(g_params, z, backend=backend,
                           fuse_epilogue=fuse_epilogue)
    d_fake = discriminator_apply(d_params, fake, backend=backend,
                                 fuse_epilogue=fuse_epilogue)
    return F.softplus(-d_fake).mean()


def gen_sgd_step(g_params: dict, d_params: dict, z: torch.Tensor, *,
                 lr=0.05, backend=None, fuse_epilogue=True):
    """One generator SGD step against a frozen discriminator:
    (new_g_params, g_loss) for the non-saturating loss."""
    z = shard(z, "dp", None)
    loss, grads = sgd_grads(
        lambda gp: _g_loss(gp, d_params, z, backend, fuse_epilogue),
        g_params)
    return sgd_update(g_params, grads, lr), loss


def gan_init(generator: torch.Generator, *, z_dim=64, base=64, ch=3,
             device=None) -> dict:
    """The full GAN training state: {"g": ..., "d": ...}."""
    return {"g": generator_init(generator, z_dim=z_dim, base=base,
                                out_ch=ch, device=device),
            "d": discriminator_init(generator, in_ch=ch, base=base,
                                    device=device)}


def gan_sgd_step(state: dict, z: torch.Tensor, real: torch.Tensor, *,
                 lr=0.05, backend=None, fuse_epilogue=True):
    """One simultaneous GAN step on the {"g", "d"} state:
    (new_state, g_loss, d_loss).  Both gradients evaluate against the
    PRE-step opposite network, so the update is a pure function of
    (state, z, real).  In the D loss the generator's params are
    constants, as `jax.value_and_grad` over the D params makes them: its
    forward runs on tensors that need no grad, so it launches its
    forward kernels and records no backward."""
    g_params, d_params = state["g"], state["d"]
    z = shard(z, "dp", None)
    real = shard(real, "dp", None, None, None)
    g_loss, g_grads = sgd_grads(
        lambda gp: _g_loss(gp, d_params, z, backend, fuse_epilogue),
        g_params)

    def d_loss_fn(dp):
        fake = generator_apply(g_params, z, backend=backend,
                               fuse_epilogue=fuse_epilogue)
        d_fake = discriminator_apply(dp, fake, backend=backend,
                                     fuse_epilogue=fuse_epilogue)
        d_real = discriminator_apply(dp, real, backend=backend,
                                     fuse_epilogue=fuse_epilogue)
        return F.softplus(-d_real).mean() + F.softplus(d_fake).mean()

    d_loss, d_grads = sgd_grads(d_loss_fn, d_params)
    return ({"g": sgd_update(g_params, g_grads, lr),
             "d": sgd_update(d_params, d_grads, lr)}, g_loss, d_loss)


def guarded_gen_sgd_step(g_params: dict, d_params: dict, z: torch.Tensor,
                         *, lr=0.05, backend=None, fuse_epilogue=True):
    """`gen_sgd_step` + the all-finite flag:
    (new_g_params, g_loss, all_finite), the flag a 0-d bool tensor left
    on the device."""
    new, loss = gen_sgd_step(g_params, d_params, z, lr=lr, backend=backend,
                             fuse_epilogue=fuse_epilogue)
    return new, loss, tree_all_finite(new, loss)


def guarded_gan_sgd_step(state: dict, z: torch.Tensor, real: torch.Tensor,
                         *, lr=0.05, backend=None, fuse_epilogue=True):
    """`gan_sgd_step` + the all-finite flag:
    (new_state, g_loss, d_loss, all_finite), the flag a 0-d bool tensor
    left on the device."""
    new, g_loss, d_loss = gan_sgd_step(state, z, real, lr=lr,
                                       backend=backend,
                                       fuse_epilogue=fuse_epilogue)
    return new, g_loss, d_loss, tree_all_finite(new, g_loss, d_loss)
