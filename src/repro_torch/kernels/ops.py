"""Public wrappers around the conv kernels (port of the conv wrappers of
`repro/kernels/ops.py`); they are the `cuda` conv backend.

Each wrapper takes fp32 tensors on one device.  On a CUDA tensor it
launches its hand-written kernel and adds one to its entry of `LAUNCHES`;
on a CPU tensor it runs the kernel's plain PyTorch version and counts
nothing.  There is no fallback: a launch that fails raises.

  dconv_forward        -> csrc/dconv_forward.cu
  tconv_phase          -> csrc/tconv_phase.cu or, when the strategy
                          planner picks it, csrc/implicit_gemm.cu
  tconv_implicit_gemm  -> tconv_phase with the implicit-GEMM strategy
"""
from __future__ import annotations

import torch

from repro_torch.core.spec import ConvSpec, Epilogue, _pair
from repro_torch.kernels import tiling
from repro_torch.kernels.dconv_forward import (dconv_forward_cuda,
                                               dconv_forward_plain)
from repro_torch.kernels.implicit_gemm import (tconv_implicit_gemm_cuda,
                                               tconv_implicit_gemm_plain)
from repro_torch.kernels.tconv_phase import (tconv_fused_cuda,
                                             tconv_fused_plain)

# Kernel launches per wrapper since the last reset.
LAUNCHES = {"dconv_forward": 0, "tconv_phase": 0, "tconv_implicit_gemm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True when the operands lie on the card, False on the CPU; raises on
    any other dtype than fp32, mixed devices or another device type."""
    devices = set()
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the conv kernels take float32 only, got "
                            f"{t.dtype}")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _epilogue_operands(bias, epilogue):
    """(bias or None, epilogue or None) as the kernels take them: an
    identity epilogue is none at all, and the bias rides only when the
    epilogue asks for it."""
    if epilogue is None or epilogue.is_identity:
        return None, None
    if epilogue.bias and bias is None:
        raise ValueError("epilogue.bias=True but no bias array was given")
    return (bias if epilogue.bias else None), epilogue


def dconv_forward(x: torch.Tensor, w: torch.Tensor, *, stride, padding,
                  dilation, bias=None,
                  epilogue: Epilogue | None = None) -> torch.Tensor:
    """Zero-free direct/dilated forward conv with a fused epilogue:
    x (B,Nh,Nw,Cin), w (Kh,Kw,Cin,Cout) -> y (B,Oh,Ow,Cout)."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=(w.shape[0], w.shape[1]),
                         dilation=dilation)
    bias, epilogue = _epilogue_operands(bias, epilogue)
    if not _on_cuda(x, w, bias):
        return dconv_forward_plain(x, w, spec, bias=bias, epilogue=epilogue)
    y = dconv_forward_cuda(x.contiguous(), w.contiguous(), spec,
                           bias=None if bias is None else bias.contiguous(),
                           epilogue=epilogue)
    LAUNCHES["dconv_forward"] += 1
    return y


def tconv_phase(dy: torch.Tensor, w: torch.Tensor, *, stride, padding,
                n_out, dilation=(1, 1), bias=None,
                epilogue: Epilogue | None = None,
                strategy: str | None = None) -> torch.Tensor:
    """Zero-free transposed conv / input gradient, any (stride,
    dilation): dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) -> dx (B,Nh,Nw,Cin).
    `tiling.plan_strategy` names the kernel family; `strategy` pins
    "phase" | "implicit_gemm" | "auto" for this call.  `epilogue` / `bias`
    fuse act(scale * . + bias) onto the output (bias over Cin)."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=(w.shape[0], w.shape[1]),
                         dilation=dilation)
    nh, nw = _pair(n_out)
    strategy = tiling.plan_strategy(
        "input_grad", spec, x_shape=(dy.shape[0], nh, nw, w.shape[2]),
        dy_shape=tuple(dy.shape), epilogue=epilogue, strategy=strategy)
    bias, epilogue = _epilogue_operands(bias, epilogue)
    ig = strategy == "implicit_gemm"
    if not _on_cuda(dy, w, bias):
        plain = tconv_implicit_gemm_plain if ig else tconv_fused_plain
        return plain(dy, w, spec, n_out=(nh, nw), bias=bias,
                     epilogue=epilogue)
    launch = tconv_implicit_gemm_cuda if ig else tconv_fused_cuda
    dx = launch(dy.contiguous(), w.contiguous(), spec, n_out=(nh, nw),
                bias=None if bias is None else bias.contiguous(),
                epilogue=epilogue)
    LAUNCHES["tconv_implicit_gemm" if ig else "tconv_phase"] += 1
    return dx


def tconv_implicit_gemm(dy: torch.Tensor, w: torch.Tensor, *, stride,
                        padding, n_out, dilation=(1, 1), bias=None,
                        epilogue: Epilogue | None = None) -> torch.Tensor:
    """`tconv_phase` pinned to the predicated implicit-GEMM kernel."""
    return tconv_phase(dy, w, stride=stride, padding=padding, n_out=n_out,
                       dilation=dilation, bias=bias, epilogue=epilogue,
                       strategy="implicit_gemm")
