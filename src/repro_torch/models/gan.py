"""DCGAN-style generator, the serving half of `repro/models/gan.py`.

The generator upsamples with `ecoflow_conv_transpose`: the paper's
zero-free transposed-conv dataflow is its forward pass.  Each layer's
relu/tanh tail rides in the transposed conv's epilogue slot.  The
discriminator and the training steps come with the training slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.conv import ecoflow_conv_transpose
from repro_torch.core.spec import ConvSpec, Epilogue
from repro_torch.device import resolve_device

_RELU = Epilogue(activation="relu")
_TANH = Epilogue(activation="tanh")

# The upsampling ladder: (param name, tconv-input spatial size, output
# spatial size, fused epilogue).  `generator_apply` and
# `generator_plan_requests` both read it, so the serving buckets plan
# exactly the launches the forward pass makes.
GENERATOR_LAYERS = (("t1", (4, 4), (8, 8), _RELU),
                    ("t2", (8, 8), (16, 16), _RELU),
                    ("t3", (16, 16), (32, 32), _TANH))


def _trunc_normal(generator: torch.Generator, shape, scale: float):
    """`scale` * truncated standard normal on [-2, 2], drawn on the CPU
    from `generator`."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return scale * t


def generator_init(generator: torch.Generator, *, z_dim=64, base=64,
                   out_ch=3, device=None) -> dict:
    """Random generator params, `repro`'s shapes and scales.  Conv filters
    are stored in direct-conv orientation (K, K, Cin, Cout) where Cin is
    the upsampled (output) side."""
    dev = resolve_device(device)

    def w(k, cin, cout):
        return _trunc_normal(generator, (k, k, cin, cout),
                             1.0 / math.sqrt(k * k * cin))

    params = {
        "proj": _trunc_normal(generator, (z_dim, 4 * 4 * base * 2),
                              1.0 / math.sqrt(z_dim)),
        "t1": w(4, base, base * 2),      # 4x4 -> 8x8
        "t2": w(4, base // 2, base),     # 8x8 -> 16x16
        "t3": w(4, out_ch, base // 2),   # 16x16 -> 32x32
    }
    return {k: v.to(dev) for k, v in params.items()}


def generator_apply(params: dict, z: torch.Tensor, *,
                    backend=None) -> torch.Tensor:
    """z (B, z_dim) -> images (B, 32, 32, out_ch) in [-1, 1]."""
    B = z.shape[0]
    x = torch.relu(torch.matmul(z, params["proj"]).reshape(B, 4, 4, -1))
    for name, _, out_hw, ep in GENERATOR_LAYERS:
        x = ecoflow_conv_transpose(x, params[name], 2, 1, n_out=out_hw,
                                   backend=backend, epilogue=ep)
    return x


def generator_plan_requests(params: dict, batch: int) -> list:
    """One `("input_grad", spec, x_shape, dy_shape, epilogue)` entry per
    transposed-conv layer of one serving bucket.  `x_shape` is the
    upsampled OUTPUT side and `dy_shape` the tconv input, matching the
    input-gradient formulation the filters are stored in."""
    entries = []
    for name, in_hw, out_hw, ep in GENERATOR_LAYERS:
        w = params[name]
        spec = ConvSpec.make(stride=2, padding=1,
                             filter_shape=tuple(w.shape[:2]))
        entries.append(("input_grad", spec,
                        (batch, out_hw[0], out_hw[1], int(w.shape[2])),
                        (batch, in_hw[0], in_hw[1], int(w.shape[3])), ep))
    return entries
