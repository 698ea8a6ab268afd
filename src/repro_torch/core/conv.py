"""EcoFlow conv entry points with zero-free gradients, dispatched through
the conv backend registry (port of `repro/core/conv.py`).

`ecoflow_conv` is a direct conv, `ecoflow_dilated_conv` the dilated
(atrous) forward conv and `ecoflow_conv_transpose` the zero-free
transposed conv of the GAN generator, each in a plain and an epilogue
form (`bias=` / `epilogue=`).  `backend` names an implementation from
`repro_torch.core.spec`: "torch_zero_free" (default), "cuda" (the
hand-written kernels) or "reference".

Each form is a `torch.autograd.Function` -- the port of `repro`'s
`jax.custom_vjp`s -- whose backward is the backend's own: `backward` /
`backward_ep` give (dx, dW[, db]) of a direct conv, `ct_backward` /
`ct_backward_ep` give (ddy, dW[, db]) of a transposed conv.  On the
`cuda` backend each of those is ONE fused kernel launch; the other
backends compose the same math.  The Functions save what `repro` saves:
(x, w) or (dy, w), plus the forward output when the epilogue's
activation needs it for its mask (act' is read from the output), and
nothing is modified in place after it is saved.  Each gradient comes
back in its operand's dtype (the bias gradient in the cotangent's), as
`repro`'s VJPs cast it: with bf16 operands the `cuda` backend's kernels
already give bf16.

The backend comes from `dispatch_backend` at every op: under a
multi-rank `parallel.sharding.use_mesh` the operands may be DTensors,
each op runs per shard (`core.spec.sharded_backend`), and each gradient
is laid out as its input (`sharding.conform`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.spec import ConvSpec, Epilogue, dispatch_backend
from repro_torch.parallel.sharding import conform


def _grad(g, like, dtype=None):
    """Gradient g in `dtype` (default `like`'s), laid out as the input
    `like` it belongs to."""
    dtype = like.dtype if dtype is None else dtype
    if g is not None and g.dtype != dtype:
        g = g.to(dtype)
    return conform(g, like)


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


class _ConvPlain(torch.autograd.Function):
    """y = conv(x, w); both gradients from the backend's `backward`."""

    @staticmethod
    def forward(ctx, x, w, spec: ConvSpec, be):
        ctx.spec, ctx.be = spec, be
        ctx.save_for_backward(x, w)
        return be.forward(x, w, spec)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ctx.be.backward(x, g, w, ctx.spec, (x.shape[1], x.shape[2]))
        return _grad(dx, x), _grad(dw, w), None, None


class _ConvEp(torch.autograd.Function):
    """y = ep(conv(x, w), b); (dx, dW, db) from the backend's
    `backward_ep`, which masks the cotangent with act'(y)."""

    @staticmethod
    def forward(ctx, x, w, b, spec: ConvSpec, be, ep: Epilogue):
        y = be.forward_ep(x, w, b, spec, ep)
        ctx.spec, ctx.be, ctx.ep, ctx.b = spec, be, ep, b
        ctx.save_for_backward(x, w, y if ep.needs_y else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        dx, dw, db = ctx.be.backward_ep(x, y, g, w, ctx.spec,
                                        (x.shape[1], x.shape[2]), ctx.ep)
        return (_grad(dx, x), _grad(dw, w), _grad(db, ctx.b, g.dtype), None,
                None, None)


class _ConvTranspose(torch.autograd.Function):
    """z = tconv(dy, w); the cotangent g sits in the input role of both
    of its gradients, (conv(g, w), filter_grad(g, dy)), from the
    backend's `ct_backward`."""

    @staticmethod
    def forward(ctx, dy, w, spec: ConvSpec, n_out, be):
        ctx.spec, ctx.be = spec, be
        ctx.save_for_backward(dy, w)
        return be.input_grad(dy, w, spec, n_out)

    @staticmethod
    def backward(ctx, g):
        dy, w = ctx.saved_tensors
        ddy, dw = ctx.be.ct_backward(g, dy, w, ctx.spec)
        return _grad(ddy, dy), _grad(dw, w), None, None, None


class _ConvTransposeEp(torch.autograd.Function):
    """z = ep(tconv(dy, w), b); (ddy, dW, db) from the backend's
    `ct_backward_ep`, which masks g with act'(z)."""

    @staticmethod
    def forward(ctx, dy, w, b, spec: ConvSpec, n_out, be, ep: Epilogue):
        z = be.input_grad_ep(dy, w, b, spec, n_out, ep)
        ctx.spec, ctx.be, ctx.ep, ctx.b = spec, be, ep, b
        ctx.save_for_backward(dy, w, z if ep.needs_y else None)
        return z

    @staticmethod
    def backward(ctx, g):
        dy, w, z = ctx.saved_tensors
        ddy, dw, db = ctx.be.ct_backward_ep(g, z, dy, w, ctx.spec, ctx.ep)
        return (_grad(ddy, dy), _grad(dw, w), _grad(db, ctx.b, g.dtype),
                None, None, None, None)


def ecoflow_conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                 backend=None, dilation=1, *, bias=None,
                 epilogue: Epilogue | None = None) -> torch.Tensor:
    """Direct conv (NHWC x HWIO -> NHWC) with zero-free gradients.
    `dilation` > 1 makes it a dilated/atrous conv.  `bias` ((Cout,))
    and/or `epilogue` fuse the layer tail act(scale * conv + bias) into
    the conv launch on the cuda backend, and its VJP masks the cotangent
    with act'(y) inside the one backward launch that also gives db; the
    other backends compose the identical math."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=tuple(w.shape[:2]), dilation=dilation)
    ep = _normalize_epilogue(epilogue, bias)
    be = dispatch_backend(backend)
    if ep is None:
        return _ConvPlain.apply(x, w, spec, be)
    return _ConvEp.apply(x, w, bias if ep.bias else None, spec, be, ep)


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
    be = dispatch_backend(backend)
    if ep is None:
        return _ConvTranspose.apply(dy, w, spec, n_out, be)
    return _ConvTransposeEp.apply(dy, w, bias if ep.bias else None, spec,
                                  n_out, be, ep)
