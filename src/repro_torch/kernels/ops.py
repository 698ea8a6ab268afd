"""Public wrappers around the kernels (port of `repro/kernels/ops.py`); the
conv wrappers are the `cuda` conv backend, `flash_attention` is the LM's
attention.

Each conv wrapper takes fp32 or bf16 tensors, one dtype for every
operand, on one device, and returns `repro`'s dtypes (the operands'); a
bf16 operand on the card launches the kernel's `_bf16` entry, which reads
bf16 from device memory, sums in fp32 and rounds once at its store.
`flash_attention` takes fp32 or bf16.  On a CUDA tensor a wrapper
launches its hand-written kernel and adds one to its entry of
`LAUNCHES`; on a CPU tensor it runs the kernel's plain PyTorch version
and counts nothing.  There is no
fallback: a launch that fails raises.  Each kernel takes its plan (tiles,
splits) from `tiling`, the Hopper planner.

The dry-run (`launch/dryrun.py`) traces the LM on fake tensors, which
have shapes and no data.  A fake operand, on the CPU as on `cuda`, takes
the card's branch of `flash_attention` and `flash_attention_backward`:
the form `attention.plan` / `backward_plan` picks, run as the kernel's
shape-only fake form (`attention.flash_attention_cuda`), which builds
and launches nothing and counts its call in `attention.FAKE_CALLS` /
FAKE_FORMS.  LAUNCHES and its form counts hold real launches only.  A
real tensor's branch is its device's.

  dconv_forward        -> csrc/dconv_forward.cu
  tconv_phase          -> csrc/tconv_phase.cu or, when the planner's
                          strategy race picks it, csrc/implicit_gemm.cu
  tconv_implicit_gemm  -> tconv_phase with the implicit-GEMM strategy
  conv_backward        -> csrc/conv_backward.cu   (dx, dW, db of a conv)
  tconv_backward       -> csrc/tconv_backward.cu  (ddy, dW, db of a tconv)
  dconv_filter_grad    -> csrc/dconv_filtergrad.cu
  flash_attention      -> csrc/flash_attention.cu, in the form
                          `attention.plan` picks (counted in FLASH_FORMS;
                          with a device `length`, the split form that
                          reads it, counted in FLASH_DEVICE_LEN too);
                          when an operand requires grad, through
                          `FlashAttentionFn`, whose backward is
  flash_attention_backward -> csrc/flash_attention_bwd.cu, in the form
                          `attention.backward_plan` picks (counted in
                          FLASH_BWD_FORMS)
"""
from __future__ import annotations

import torch

from repro_torch.core.spec import ConvSpec, Epilogue, _pair
from repro_torch.kernels import attention, build, tiling
from repro_torch.kernels.attention import (BWD_FORMS, FORMS, HEAD_DIMS,
                                           backward_plan,
                                           flash_attention_backward_cuda,
                                           flash_attention_backward_plain,
                                           flash_attention_cuda,
                                           flash_attention_plain,
                                           is_fake, plan)
from repro_torch.kernels.dconv_backward import (conv_backward_cuda,
                                                conv_backward_plain,
                                                tconv_backward_cuda,
                                                tconv_backward_plain)
from repro_torch.kernels.dconv_filtergrad import (dconv_filter_grad_cuda,
                                                  dconv_filter_grad_plain)
from repro_torch.kernels.dconv_forward import (dconv_forward_cuda,
                                               dconv_forward_plain)
from repro_torch.kernels.implicit_gemm import (tconv_implicit_gemm_cuda,
                                               tconv_implicit_gemm_plain)
from repro_torch.kernels.tconv_phase import (tconv_fused_cuda,
                                             tconv_fused_plain)

# Kernel launches per wrapper since the last reset.
LAUNCHES = {"dconv_forward": 0, "tconv_phase": 0, "tconv_implicit_gemm": 0,
            "conv_backward": 0, "tconv_backward": 0, "dconv_filter_grad": 0,
            "flash_attention": 0, "flash_attention_backward": 0}
# flash_attention's launches by kernel form (they sum to its LAUNCHES),
# and flash_attention_backward's calls by form (they sum to its).
FLASH_FORMS = dict.fromkeys(FORMS, 0)
FLASH_BWD_FORMS = dict.fromkeys(BWD_FORMS, 0)
# flash_attention's launches that read the cache length from the device
# (a part of FLASH_FORMS["split"]).
FLASH_DEVICE_LEN = {"split": 0}


def reset_launches() -> None:
    """Zero LAUNCHES, the form counts and the fake forms' counts."""
    for counts in (LAUNCHES, FLASH_FORMS, FLASH_BWD_FORMS, FLASH_DEVICE_LEN,
                   attention.FAKE_CALLS, attention.FAKE_FLOPS,
                   *attention.FAKE_FORMS.values()):
        for name in counts:
            counts[name] = 0


def launches_since(before: dict) -> dict:
    """LAUNCHES less `before` (an earlier copy of it), for the wrappers
    that launched since: what a CUDA-graph capture recorded."""
    return {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
            if n != before.get(k, 0)}


def _plain(t: torch.Tensor) -> bool:
    """True where the attention wrappers run the plain version: a real
    CPU tensor (a fake one takes the card's branch, as a fake form)."""
    return t.device.type == "cpu" and not is_fake(t)


def _on_cuda(*tensors) -> bool:
    """True when the operands lie on the card, False on the CPU; raises on
    any other dtype than fp32 or bf16, on operands of two dtypes (the
    kernels read every operand in one), on mixed devices or another
    device type."""
    devices, dtypes = set(), set()
    for t in tensors:
        if t is None:
            continue
        if t.dtype not in build.CONV_DTYPES:
            raise TypeError(f"the conv kernels take float32 or bfloat16, "
                            f"got {t.dtype}")
        dtypes.add(t.dtype)
        devices.add(t.device)
    if len(dtypes) > 1:
        raise TypeError("the conv kernels take one dtype for every operand, "
                        "got " + " and ".join(sorted(map(str, dtypes))))
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_channels(x_like, dy_like, w) -> None:
    """The kernels index w by the channels of their operands: refuse a
    filter that does not fit them."""
    if w.dim() != 4 or x_like.dim() != 4 or dy_like.dim() != 4 or \
            w.shape[2] != x_like.shape[3] or w.shape[3] != dy_like.shape[3]:
        raise ValueError(f"filter {tuple(w.shape)} does not map "
                         f"{tuple(x_like.shape)} to {tuple(dy_like.shape)}")


def _check_out_size(spec: ConvSpec, x_like, dy_like) -> None:
    if spec.out_size((x_like.shape[1], x_like.shape[2])) != \
            (dy_like.shape[1], dy_like.shape[2]):
        raise ValueError(
            f"dy spatial {tuple(dy_like.shape[1:3])} inconsistent with "
            f"{tuple(x_like.shape[1:3])} for stride={spec.stride}, "
            f"padding={spec.padding}, filter={spec.filter_shape}, "
            f"dilation={spec.dilation}: forward yields "
            f"{spec.out_size((x_like.shape[1], x_like.shape[2]))}")


def _backward_epilogue(epilogue, out, name):
    """The epilogue a backward takes (an identity one is none at all) and
    the forward output it masks with, or None when nothing is masked."""
    if epilogue is not None and epilogue.is_identity:
        epilogue = None
    if epilogue is None or not epilogue.needs_y:
        return epilogue, None
    if out is None:
        raise ValueError(f"epilogue has an activation but no forward "
                         f"output residual {name} was given")
    return epilogue, out


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
    bias, epilogue = _epilogue_operands(bias, epilogue)
    on_card = _on_cuda(dy, w, bias)
    # The plain versions need no plan: on the CPU only the strategy counts,
    # and it is the analytical one (no sweep times a CPU tensor).
    strategy, plan_ = tiling.plan_strategy(
        "input_grad", spec, x_shape=(dy.shape[0], nh, nw, w.shape[2]),
        dy_shape=tuple(dy.shape), epilogue=epilogue, strategy=strategy,
        mode=None if on_card else "analytical", dtype=dy.dtype)
    ig = strategy == "implicit_gemm"
    if not on_card:
        plain = tconv_implicit_gemm_plain if ig else tconv_fused_plain
        return plain(dy, w, spec, n_out=(nh, nw), bias=bias,
                     epilogue=epilogue)
    launch = tconv_implicit_gemm_cuda if ig else tconv_fused_cuda
    dx = launch(dy.contiguous(), w.contiguous(), spec, n_out=(nh, nw),
                bias=None if bias is None else bias.contiguous(),
                epilogue=epilogue, plan=plan_)
    LAUNCHES["tconv_implicit_gemm" if ig else "tconv_phase"] += 1
    return dx


def tconv_implicit_gemm(dy: torch.Tensor, w: torch.Tensor, *, stride,
                        padding, n_out, dilation=(1, 1), bias=None,
                        epilogue: Epilogue | None = None) -> torch.Tensor:
    """`tconv_phase` pinned to the predicated implicit-GEMM kernel."""
    return tconv_phase(dy, w, stride=stride, padding=padding, n_out=n_out,
                       dilation=dilation, bias=bias, epilogue=epilogue,
                       strategy="implicit_gemm")


def conv_backward(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, *,
                  stride, padding, n_out, dilation=(1, 1), y=None,
                  epilogue: Epilogue | None = None):
    """Fused dual-gradient backward of a direct conv, ONE launch:
    x (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) ->
    (dx (B,*n_out,Cin), dW (Kh,Kw,Cin,Cout)).  With `epilogue` this is
    the VJP of the epilogue-fused forward (`y` its output): act'(y) masks
    dy as it is loaded, and the return is (dx, dW, db|None)."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=(w.shape[0], w.shape[1]),
                         dilation=dilation)
    n_out = _pair(n_out)
    epilogue, y = _backward_epilogue(epilogue, y, "y")
    _check_channels(x, dy, w)
    _check_out_size(spec, x, dy)
    if y is not None and y.shape != dy.shape:
        raise ValueError(f"y {tuple(y.shape)} is not shaped like dy "
                         f"{tuple(dy.shape)}")
    if not _on_cuda(x, dy, w, y):
        dx, dw, db = conv_backward_plain(x, dy, w, spec, n_out=n_out, y=y,
                                         epilogue=epilogue)
    else:
        dx, dw, db = conv_backward_cuda(
            x.contiguous(), dy.contiguous(), w.contiguous(), spec,
            n_out=n_out, y=None if y is None else y.contiguous(),
            epilogue=epilogue)
        LAUNCHES["conv_backward"] += 1
    return (dx, dw) if epilogue is None else (dx, dw, db)


def tconv_backward(g: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, *,
                   stride, padding, dilation=(1, 1), z=None,
                   epilogue: Epilogue | None = None):
    """Fused backward of the transposed conv z = tconv(dy, w), ONE launch:
    g (B,Nh,Nw,Cin) cotangent of z, dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout)
    -> (ddy (B,Oh,Ow,Cout), dW (Kh,Kw,Cin,Cout)).  With `epilogue` (`z`
    its output) act'(z) masks g as it is loaded, and the return is
    (ddy, dW, db|None) with db over Cin."""
    spec = ConvSpec.make(stride=stride, padding=padding,
                         filter_shape=(w.shape[0], w.shape[1]),
                         dilation=dilation)
    epilogue, z = _backward_epilogue(epilogue, z, "z")
    _check_channels(g, dy, w)
    _check_out_size(spec, g, dy)
    if z is not None and z.shape != g.shape:
        raise ValueError(f"z {tuple(z.shape)} is not shaped like g "
                         f"{tuple(g.shape)}")
    if not _on_cuda(g, dy, w, z):
        ddy, dw, db = tconv_backward_plain(g, dy, w, spec, z=z,
                                           epilogue=epilogue)
    else:
        ddy, dw, db = tconv_backward_cuda(
            g.contiguous(), dy.contiguous(), w.contiguous(), spec,
            z=None if z is None else z.contiguous(), epilogue=epilogue)
        LAUNCHES["tconv_backward"] += 1
    return (ddy, dw) if epilogue is None else (ddy, dw, db)


def dconv_filter_grad(x: torch.Tensor, dy: torch.Tensor, *, stride, padding,
                      k, dilation=(1, 1)) -> torch.Tensor:
    """Zero-free filter gradient: x (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout) ->
    dW (Kh,Kw,Cin,Cout), k = (Kh, Kw)."""
    spec = ConvSpec.make(stride=stride, padding=padding, filter_shape=k,
                         dilation=dilation)
    _check_out_size(spec, x, dy)
    if not _on_cuda(x, dy):
        return dconv_filter_grad_plain(x, dy, spec)
    dw = dconv_filter_grad_cuda(x.contiguous(), dy.contiguous(), spec)
    LAUNCHES["dconv_filter_grad"] += 1
    return dw


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int | None = None,
                    blk_k: int = 128, return_lse: bool = False,
                    length: torch.Tensor | None = None):
    """Blockwise causal GQA attention: q (B,Sq,Hq,D), k/v (B,Sk,Hk,D),
    Hq % Hk == 0 -> (B,Sq,Hq,D) in q's dtype (fp32 or bf16, the same for
    all three).  With `causal`, key j is visible to query i iff
    j <= q_offset + i; `q_offset` defaults to Sk - Sq.  k and v may be
    strided views (the live prefix of a KV cache): the kernel reads them
    in place.  `blk_k` is the plain version's kv block on the CPU; the
    kernel has its own.  When autograd records and an operand requires
    grad, the call goes through `FlashAttentionFn` (on the card its
    backward is a kernel too).  With `return_lse` (no gradient) the same
    launch also gives the rows' log-sum-exps: (out, lse (B,Hq,Sq) fp32),
    the statistics a split-sequence decode combines across ranks.

    `length`, a 0-d int32 on the operands' device, is a decode step's
    cache length read where it lies (the graph form of `LM.decode_step`,
    whose CUDA graph cannot take it by value): k, v are a bucket view
    cache[:, :extent], the queries sit at positions length ..
    length + Sq - 1, and the keys at or past length + Sq are not live.
    It takes the split form (`plan` at the extent must give it), no
    q_offset and no gradient."""
    off = _check_attention(q, k, v, causal, q_offset)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if length is not None:
        _check_length(q, k, length, q_offset, grad)
    if grad:
        if return_lse:
            raise ValueError("return_lse takes no gradient")
        return FlashAttentionFn.apply(q, k, v, causal, off, blk_k)
    return _flash_forward(q, k, v, causal, off, blk_k, return_lse=return_lse,
                          length=length)


def _check_length(q, k, length, q_offset, grad: bool) -> None:
    """Raise on a device length the split form cannot take."""
    if q_offset is not None or grad:
        raise ValueError("a device length takes no q_offset and no "
                         "gradient")
    if not isinstance(length, torch.Tensor) or length.dim() != 0 or \
            length.dtype != torch.int32 or length.device != q.device:
        raise ValueError(f"length must be a 0-d int32 tensor on {q.device}")
    form = plan(q.dtype, q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                k.shape[2], q.shape[3])
    if form.form != "split":
        raise ValueError(f"a device length takes the split form; these "
                         f"shapes take {form.form}")


def _check_attention(q, k, v, causal: bool, q_offset) -> int:
    """Raise on operands the kernel does not take; return the q_offset."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"expected q (B,Sq,Hq,D) and k, v (B,Sk,Hk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    dtypes = {q.dtype, k.dtype, v.dtype}
    if len(dtypes) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, one "
                        f"dtype for q, k and v; got {dtypes}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    _, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hk == 0 or Hq % Hk:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hk} kv "
                         f"heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if Sk == 0:
        raise ValueError("no keys: Sk must be at least 1")
    off = Sk - Sq if q_offset is None else int(q_offset)
    if causal and off < 0:
        raise ValueError(f"causal attention needs q_offset >= 0 (every query "
                         f"sees key 0), got {off}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return off


def _flash_forward(q, k, v, causal: bool, off: int, blk_k: int, *,
                   return_lse: bool, length=None):
    """The forward on checked operands: the plain version on the CPU, one
    kernel launch on the card (a fake operand: the kernel's fake form)."""
    if _plain(q):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=off,
                                     blk_k=blk_k, return_lse=return_lse,
                                     length=length)
    form = plan(q.dtype, q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                k.shape[2], q.shape[3])
    out = flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                               form=form, return_lse=return_lse,
                               length=length)
    if not is_fake(q):          # a fake form counts itself (FAKE_CALLS)
        LAUNCHES["flash_attention"] += 1
        FLASH_FORMS[form.form] += 1
        if length is not None:
            FLASH_DEVICE_LEN[form.form] += 1
    return out


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool,
                             q_offset: int, blk_k: int = 128):
    """(dq, dk, dv) of `flash_attention(q, k, v)` = `out` at cotangent
    `dout`, from the forward's row log-sum-exps `lse` (B,Hq,Sq).  On the
    card the three launches of csrc/flash_attention_bwd.cu in the form
    `attention.backward_plan` picks (counted once here and in
    FLASH_BWD_FORMS; a fake operand: its fake form, counted there); on
    the CPU the plain version.  A failed launch
    raises."""
    if _plain(q):
        return flash_attention_backward_plain(q, k, v, out, dout, lse,
                                              causal=causal,
                                              q_offset=q_offset, blk_k=blk_k)
    form = backward_plan(q.dtype, q.shape[0], q.shape[1], k.shape[1],
                         q.shape[2], k.shape[2], q.shape[3])
    # Autograd hands over whatever dout its consumer gave (a transpose's
    # gradient is strided): in training a copy is acceptable.
    grads = flash_attention_backward_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), out.contiguous(),
        dout.contiguous(), lse, causal=causal, q_offset=q_offset, form=form)
    if not is_fake(q):
        LAUNCHES["flash_attention_backward"] += 1
        FLASH_BWD_FORMS[form] += 1
    return grads


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward also writes the rows'
    log-sum-exps and saves (q, k, v, out, lse); the backward is
    `flash_attention_backward`.  Under `torch.utils.checkpoint` the
    forward runs again in the backward pass and saves its lse again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, off, blk_k):
        out, lse = _flash_forward(q, k, v, causal, off, blk_k,
                                  return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.off, ctx.blk_k = causal, off, blk_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout, lse, causal=ctx.causal, q_offset=ctx.off,
            blk_k=ctx.blk_k)
        return dq, dk, dv, None, None, None
