"""int8 error-feedback gradient compression over an explicit all-reduce
(port of `repro/parallel/compression.py`): the optional cross-pod
bandwidth saver.

Per-tensor max-abs int8 quantization with a persistent error-feedback
accumulator, so the quantization noise is unbiased over steps
(1-bit-Adam-style residual correction).  `repro`'s arithmetic: each rank
quantizes its value plus its carried error, and the mean over the axis
is the all-reduce of the DEQUANTIZED values divided by the all-reduced
count of ranks.  Here the two travel in one `dist.all_reduce` (the count
packed after the values) on the axis' group of a `DeviceMesh`; each rank
passes its own tensors, as a `shard_map` body sees its shard.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import tree_map
from repro_torch.parallel import sharding as sh


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scale): scale = max(max |x|, 1e-12) / 127, codes
    round(x / scale) (half to even, as `jnp.round`) clipped to +-127."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, mesh, axis, error: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of `x` over the mesh axis `axis` (a name or a tuple) with
    int8 compression and error feedback: (reduced in x's dtype, this
    rank's new error).  One all-reduce over the axis."""
    xf = x.to(torch.float32) + error
    q, scale = quantize_int8(xf)
    deq = dequantize_int8(q, scale)
    new_error = xf - deq
    packed = sh.psum(torch.cat([deq.flatten(),
                                torch.ones(1, device=deq.device)]),
                     mesh, axis)
    summed, n = packed[:-1].view(deq.shape), packed[-1]
    return (summed / n).to(x.dtype), new_error


def make_compressed_grad_allreduce(mesh, axis_name: str = "pod"):
    """f(grads, errors) -> (grads, errors): one compressed all-reduce per
    leaf over `axis_name`, each leaf this rank's tensor."""
    def f(grads, errors):
        outs = tree_map(lambda g, e: compressed_psum(g, mesh, axis_name, e),
                        grads, errors)
        return (tree_map(lambda _, o: o[0], grads, outs),
                tree_map(lambda _, o: o[1], grads, outs))

    return f
