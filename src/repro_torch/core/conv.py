"""EcoFlow conv entry points, dispatched through the conv backend registry
(port of the forward half of `repro/core/conv.py`).

`ecoflow_conv` is a direct conv, `ecoflow_dilated_conv` the dilated
(atrous) forward conv and `ecoflow_conv_transpose` the zero-free
transposed conv of the GAN generator, each in a plain and an epilogue
form (`bias=` / `epilogue=`).  `backend` names an implementation from
`repro_torch.core.spec`: "torch_zero_free" (default), "cuda" (the
hand-written kernels) or "reference".

This slice serves inference only on the `cuda` backend: its backward
kernels come with the training slice, together with the
`torch.autograd.Function`s that route gradients through them, so an
input that requires grad raises there.  The `reference` and
`torch_zero_free` backends are plain PyTorch ops and differentiate
through autograd.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.spec import ConvBackend, ConvSpec, Epilogue, \
    resolve_backend


def _normalize_epilogue(epilogue, bias):
    """Fold the `bias=` / `epilogue=` kwargs into one descriptor, or None
    for the plain path: a bias with no descriptor is a pure bias-add
    epilogue, a descriptor with `bias=False` plus a bias is promoted, and
    identity descriptors with no bias collapse to None."""
    if epilogue is None:
        return Epilogue(bias=True) if bias is not None else None
    if bias is not None and not epilogue.bias:
        epilogue = dataclasses.replace(epilogue, bias=True)
    if epilogue.bias and bias is None:
        raise ValueError("epilogue.bias=True but no bias array was given")
    return None if epilogue.is_identity else epilogue


def _inference_backend(backend, *tensors) -> ConvBackend:
    be = resolve_backend(backend)
    if be.name == "cuda" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the cuda backend serves inference only until the training "
            "slice: run under torch.no_grad(), or use the reference or "
            "torch_zero_free backend to differentiate")
    return be


def ecoflow_conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                 backend=None, dilation=1, *, bias=None,
                 epilogue: Epilogue | None = None) -> torch.Tensor:
    """Direct conv (NHWC x HWIO -> NHWC).  `dilation` > 1 makes it a
    dilated/atrous conv.  `bias` ((Cout,)) and/or `epilogue` fuse the
    layer tail act(scale * conv + bias) into the conv launch on the cuda
    backend; the other backends compose the identical math."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=tuple(w.shape[:2]), dilation=dilation)
    ep = _normalize_epilogue(epilogue, bias)
    be = _inference_backend(backend, x, w, bias)
    if ep is None:
        return be.forward(x, w, spec)
    return be.forward_ep(x, w, bias if ep.bias else None, spec, ep)


def ecoflow_dilated_conv(x: torch.Tensor, w: torch.Tensor, stride=1,
                         padding=0, dilation=2, backend=None, *, bias=None,
                         epilogue: Epilogue | None = None) -> torch.Tensor:
    """Zero-free dilated (atrous) forward convolution: the filter is
    applied at tap spacing `dilation` without materializing its
    D*(K-1)+1 effective extent."""
    return ecoflow_conv(x, w, stride, padding, backend, dilation,
                        bias=bias, epilogue=epilogue)


def ecoflow_conv_transpose(dy: torch.Tensor, w: torch.Tensor, stride=1,
                           padding=0, n_out=None, backend=None, dilation=1,
                           *, bias=None,
                           epilogue: Epilogue | None = None) -> torch.Tensor:
    """Zero-free transposed conv (e.g. GAN generator layers): dy (B, Oh,
    Ow, Cout), w (Kh, Kw, Cin, Cout) in direct-conv orientation -> (B,
    Nh, Nw, Cin), (Nh, Nw) = n_out (default exact fit).  `dilation` > 1
    makes it the adjoint of a dilated forward conv."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=tuple(w.shape[:2]), dilation=dilation)
    if n_out is None:
        n_out = spec.input_size((dy.shape[1], dy.shape[2]))
    n_out = tuple(int(n) for n in n_out)
    # dy must be the forward-conv output of an n_out-sized input.
    if spec.out_size(n_out) != (dy.shape[1], dy.shape[2]):
        raise ValueError(
            f"n_out={n_out} is inconsistent with dy spatial size "
            f"{tuple(dy.shape[1:3])} for stride={spec.stride}, "
            f"padding={spec.padding}, filter={spec.filter_shape}, "
            f"dilation={spec.dilation}: a forward conv over n_out yields "
            f"{spec.out_size(n_out)}")
    ep = _normalize_epilogue(epilogue, bias)
    be = _inference_backend(backend, dy, w, bias)
    if ep is None:
        return be.input_grad(dy, w, spec, n_out)
    return be.input_grad_ep(dy, w, bias if ep.bias else None, spec, n_out,
                            ep)
