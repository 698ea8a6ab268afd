"""Parameters of `repro` into the port.

`repro` and `repro_torch` share the public layout (activations NHWC,
filters HWIO with the transposed-conv filters in direct-conv
orientation), so `repro`'s params, given as numpy arrays under the same
dict keys, become the port's by a copy -- no transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None):
    """Copy a (nested dict / list / tuple) tree of arrays into tensors on
    `device` (`None` = the card), keeping keys, structure and dtype."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.tensor(np.asarray(node), device=dev)

    return conv(tree)
