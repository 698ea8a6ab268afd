"""ConvSpec: normalized convolution geometry + the conv backend registry
(port of `repro/core/spec.py`).

Backends implement the conv ops behind one interface and register under
a name:

  * ``reference``       -- torch autograd of `F.conv2d` (the oracle; it
                           materializes dilation zeros).
  * ``torch_zero_free`` -- the EcoFlow phase/tap decomposition in dense
                           PyTorch ops (port of ``xla_zero_free``).
  * ``cuda``            -- the hand-written CUDA kernels of
                           `kernels/ops.py`, forward and backward slots
                           alike: each fused backward slot is one kernel
                           launch.  On CPU tensors each kernel wrapper
                           runs its plain PyTorch version.

`dispatch_backend` is the mesh-aware `resolve_backend` that
`core/conv.py` calls at every op: under `parallel.sharding.use_mesh` it
gives `sharded_backend`'s per-shard wrapper, which runs the base backend
on each rank's blocks.

`resolve_backend` also takes `repro`'s legacy bool (True -> cuda, False
-> torch_zero_free) and a tuple or list of designators, which resolves
through `fallback_backend`: a degradation ladder trying each rung in
order.  On CPU operands any exception of a rung degrades, as in
`repro`; on CUDA operands only an injected fault does (`may_degrade`):
a plain rung never stands in for a kernel that failed to build or
launch, and no rung runs after an error that may have broken the CUDA
context.  The conv serving engine walks its own ladder under the same
rule (`serve/conv_engine.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel.sharding import current_mesh, mesh_size

# A backend designator: None (default), the legacy bool, a name, a
# ConvBackend, or a sequence of designators (a `fallback_backend` ladder).
BackendLike = Union[None, bool, str, "ConvBackend",
                    Sequence[Union[None, bool, str, "ConvBackend"]]]

DEFAULT_BACKEND = "torch_zero_free"

_ACTIVATIONS = ("none", "relu", "leaky_relu", "tanh")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Elementwise tail fused into a conv launch: y = act(scale * conv +
    bias), applied in that order (scale, then bias, then activation).

    Every supported activation's derivative is recoverable from the
    activation OUTPUT y: relu' = (y > 0), leaky_relu' = where(y > 0, 1,
    slope) for slope > 0, tanh' = 1 - y^2 (`grad_factor`)."""
    activation: str = "none"
    bias: bool = False
    slope: float = 0.01           # leaky_relu negative slope (> 0)
    scale: Optional[float] = None  # scalar multiplier on the conv output

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown epilogue activation "
                             f"{self.activation!r}; expected one of "
                             f"{_ACTIVATIONS}")
        if self.activation == "leaky_relu" and not self.slope > 0:
            raise ValueError(f"leaky_relu slope must be > 0, "
                             f"got {self.slope}")

    @property
    def is_identity(self) -> bool:
        return (self.activation == "none" and not self.bias
                and self.scale is None)

    @property
    def needs_y(self) -> bool:
        """True when the backward needs the forward output residual."""
        return self.activation != "none"

    @property
    def tag(self) -> str:
        """Compact stable string for cache keys / bench rows."""
        if self.is_identity:
            return "none"
        act = self.activation
        if act == "leaky_relu":
            act += f"{self.slope:g}"
        parts = (["b"] if self.bias else []) \
            + ([act] if act != "none" else [])
        if self.scale is not None:
            parts.append(f"s{self.scale:g}")
        return "+".join(parts)

    def apply(self, vals: torch.Tensor, bias=None) -> torch.Tensor:
        """Forward tail: act(scale * vals + bias)."""
        if self.bias and bias is None:
            raise ValueError("epilogue requests a bias but none was given")
        if self.scale is not None:
            vals = vals * self.scale
        if bias is not None:
            vals = vals + bias.to(vals.dtype)
        if self.activation == "relu":
            vals = torch.clamp_min(vals, 0.0)
        elif self.activation == "leaky_relu":
            vals = torch.where(vals > 0, vals, self.slope * vals)
        elif self.activation == "tanh":
            vals = torch.tanh(vals)
        return vals

    def grad_factor(self, y: torch.Tensor):
        """Activation derivative act'(pre), computed from the OUTPUT y."""
        if self.activation == "relu":
            return (y > 0).to(y.dtype)
        if self.activation == "leaky_relu":
            return torch.where(y > 0, 1.0, self.slope).to(y.dtype)
        if self.activation == "tanh":
            return 1.0 - torch.square(y)
        return None

    def mask_cotangent(self, y: torch.Tensor, g: torch.Tensor):
        """g * act'(y): the masked (UNSCALED) cotangent."""
        f = self.grad_factor(y)
        return g if f is None else g * f.to(g.dtype)


def _pair(v) -> tuple[int, int]:
    """Normalize an int-or-2-sequence to an (int, int) tuple."""
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected 2 elements, got {v!r}")
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static geometry of one convolution (NHWC x HWIO).  Construct with
    `ConvSpec.make` for int -> pair normalization and validation."""
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int] = (0, 0)
    filter_shape: tuple[int, int] = (1, 1)   # (Kh, Kw)
    dilation: tuple[int, int] = (1, 1)       # forward filter dilation

    @classmethod
    def make(cls, *, stride=1, padding=0, filter_shape=1,
             dilation=1) -> "ConvSpec":
        """Validated constructor: degenerate geometry raises ValueError."""
        stride = _pair(stride)
        padding = _pair(padding)
        filter_shape = _pair(filter_shape)
        dilation = _pair(dilation)
        if min(stride) < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if min(padding) < 0:
            raise ValueError(f"padding must be >= 0, got {padding}")
        if min(filter_shape) < 1:
            raise ValueError(f"filter_shape must be >= 1, got {filter_shape}")
        if min(dilation) < 1:
            raise ValueError(f"dilation must be >= 1, got {dilation}")
        return cls(stride, padding, filter_shape, dilation)

    # -- forward geometry ---------------------------------------------------

    @property
    def dilated_filter_shape(self) -> tuple[int, int]:
        """Effective receptive field K_eff = D*(K-1) + 1 per axis."""
        return tuple(self.dilation[i] * (self.filter_shape[i] - 1) + 1
                     for i in range(2))

    def out_size(self, in_size: Sequence[int]) -> tuple[int, int]:
        """Forward output spatial size O = floor((N + 2P - K_eff)/S) + 1."""
        n = _pair(in_size)
        ke = self.dilated_filter_shape
        return tuple((n[i] + 2 * self.padding[i] - ke[i])
                     // self.stride[i] + 1 for i in range(2))

    def input_size(self, out_size: Sequence[int]) -> tuple[int, int]:
        """Exact-fit forward input size N = S*(O-1) + K_eff - 2P."""
        o = _pair(out_size)
        ke = self.dilated_filter_shape
        return tuple(self.stride[i] * (o[i] - 1) + ke[i]
                     - 2 * self.padding[i] for i in range(2))

    def full_size(self, out_size: Sequence[int]) -> tuple[int, int]:
        """Pre-padding-slice transposed-conv output size F = S*(O-1) +
        K_eff."""
        o = _pair(out_size)
        ke = self.dilated_filter_shape
        return tuple(self.stride[i] * (o[i] - 1) + ke[i]
                     for i in range(2))

    # -- phase (EcoFlow) bookkeeping, dilation 1 ------------------------------

    @property
    def n_phases(self) -> int:
        """Number of stride phases S_h * S_w of the transposed conv."""
        return self.stride[0] * self.stride[1]

    def phase_index(self, p: int, q: int) -> int:
        """Linear index of phase (p, q) in the packed phase-major layout."""
        return p * self.stride[1] + q

    def phase_filter_shape(self, p: int, q: int) -> tuple[int, int]:
        """Sub-filter taps of phase (p, q): ceil((K - p)/S) per axis."""
        return (max(0, -(-(self.filter_shape[0] - p) // self.stride[0])),
                max(0, -(-(self.filter_shape[1] - q) // self.stride[1])))

    @property
    def packed_phase_shape(self) -> tuple[int, int]:
        """Uniform (zero-padded) sub-filter shape ceil(K/S) per axis."""
        return (-(-self.filter_shape[0] // self.stride[0]),
                -(-self.filter_shape[1] // self.stride[1]))

    def useful_taps(self) -> int:
        """Total taps over all phases == Kh*Kw (the zero-free property)."""
        return sum(kp * kq
                   for p in range(self.stride[0])
                   for q in range(self.stride[1])
                   for kp, kq in [self.phase_filter_shape(p, q)])

    # -- stride x dilation general (tap-phase) bookkeeping -------------------
    # Tap kx of a stride-S, dilation-D forward conv lands on transposed-conv
    # rows r = i*S + kx*D, residue class (kx*D) mod S.  Residues repeat with
    # period S/gcd(S, D) in kx; taps kx = a + u*period of class `a` land on
    # phase rows m = i + (a*D)//S + u*(D/gcd(S, D)).

    @property
    def tap_phase_period(self) -> tuple[int, int]:
        """Tap-grouping period S/gcd(S, D) per axis."""
        return tuple(self.stride[i] // math.gcd(self.stride[i],
                                                self.dilation[i])
                     for i in range(2))

    @property
    def tap_phase_step(self) -> tuple[int, int]:
        """Phase-row spacing D/gcd(S, D) between successive taps of one
        residue class."""
        return tuple(self.dilation[i] // math.gcd(self.stride[i],
                                                  self.dilation[i])
                     for i in range(2))

    @property
    def n_tap_phases(self) -> tuple[int, int]:
        """Non-empty residue classes min(K, period) per axis."""
        per = self.tap_phase_period
        return tuple(min(self.filter_shape[i], per[i]) for i in range(2))

    @property
    def taps_per_phase(self) -> tuple[int, int]:
        """Uniform (zero-padded) within-phase tap count ceil(K/period)."""
        per = self.tap_phase_period
        return tuple(-(-self.filter_shape[i] // per[i]) for i in range(2))

    def tap_phase_residue(self, a: int, axis: int) -> int:
        """Output residue class (a*D) mod S of tap-phase `a` on `axis`."""
        return (a * self.dilation[axis]) % self.stride[axis]

    def tap_phase_base(self, a: int, axis: int) -> int:
        """Leading phase-row offset (a*D) // S of tap-phase `a`."""
        return (a * self.dilation[axis]) // self.stride[axis]


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvBackend:
    """One implementation of the conv ops.

    forward(x, w, spec)                -> y     (B,N,N,Cin)x(K,K,Cin,Cout)
    input_grad(dy, w, spec, n_out)     -> dx    zero-free transposed conv
    filter_grad(x, dy, spec)           -> dw    zero-free dilated conv

    Optional fused slots replace the generic compositions of the methods
    below; a backend without them composes the primitive ops with
    `Epilogue.apply` / `Epilogue.mask_cotangent` -- identical math."""
    name: str
    forward: Callable
    input_grad: Callable
    filter_grad: Callable
    # (x, dy, w, spec, n_out) -> (dx, dw)
    fused_backward: Union[Callable, None] = None
    # (g, dy, w, spec) -> (ddy, dw)
    fused_ct_backward: Union[Callable, None] = None
    # (x, w, bias, spec, ep) -> y
    fused_forward_ep: Union[Callable, None] = None
    # (dy, w, bias, spec, n_out, ep) -> x
    fused_input_grad_ep: Union[Callable, None] = None
    # (x, y, dy, w, spec, n_out, ep) -> (dx, dw, db|None)
    fused_backward_ep: Union[Callable, None] = None
    # (g, z, dy, w, spec, ep) -> (ddy, dw, db|None)
    fused_ct_backward_ep: Union[Callable, None] = None
    # False where the ops do host-side work on every call that a CUDA
    # graph's replay would skip (`serve.faults.inject_backend`'s events):
    # such a rung is served eagerly.
    graphable: bool = True

    def backward(self, x, dy, w, spec: ConvSpec, n_out):
        """Both gradients of direct_conv(x, w, spec): (dx, dw)."""
        if self.fused_backward is not None:
            return self.fused_backward(x, dy, w, spec, n_out)
        dx = self.input_grad(dy, w, spec, n_out)
        dw = self.filter_grad(x, dy, spec)
        return dx, dw

    def ct_backward(self, g, dy, w, spec: ConvSpec):
        """Both gradients of the transposed conv tconv(dy, w, spec) w.r.t.
        cotangent g: (ddy, dw)."""
        if self.fused_ct_backward is not None:
            return self.fused_ct_backward(g, dy, w, spec)
        ddy = self.forward(g, w, spec)
        dw = self.filter_grad(g, dy, spec)
        return ddy, dw

    def forward_ep(self, x, w, bias, spec: ConvSpec, ep: Epilogue):
        """y = ep.apply(forward(x, w), bias)."""
        if self.fused_forward_ep is not None:
            return self.fused_forward_ep(x, w, bias, spec, ep)
        return ep.apply(self.forward(x, w, spec), bias)

    def input_grad_ep(self, dy, w, bias, spec: ConvSpec, n_out,
                      ep: Epilogue):
        """Transposed conv with a fused tail (tconv-as-a-layer)."""
        if self.fused_input_grad_ep is not None:
            return self.fused_input_grad_ep(dy, w, bias, spec, n_out, ep)
        return ep.apply(self.input_grad(dy, w, spec, n_out), bias)

    def backward_ep(self, x, y, dy, w, spec: ConvSpec, n_out,
                    ep: Epilogue):
        """VJP of forward_ep: (dx, dw, db|None)."""
        if self.fused_backward_ep is not None:
            return self.fused_backward_ep(x, y, dy, w, spec, n_out, ep)
        m = ep.mask_cotangent(y, dy)
        db = m.sum(dim=(0, 1, 2)) if ep.bias else None
        if ep.scale is not None:
            m = m * ep.scale
        dx, dw = self.backward(x, m, w, spec, n_out)
        return dx, dw, db

    def ct_backward_ep(self, g, z, dy, w, spec: ConvSpec, ep: Epilogue):
        """VJP of input_grad_ep (z is its forward output):
        (ddy, dw, db|None)."""
        if self.fused_ct_backward_ep is not None:
            return self.fused_ct_backward_ep(g, z, dy, w, spec, ep)
        m = ep.mask_cotangent(z, g)
        db = m.sum(dim=(0, 1, 2)) if ep.bias else None
        if ep.scale is not None:
            m = m * ep.scale
        ddy, dw = self.ct_backward(m, dy, w, spec)
        return ddy, dw, db


# The nine ops of a backend, by method name: the first three are its
# plain slots, the rest its `fused_<op>` slots.
OPS = ("forward", "input_grad", "filter_grad", "backward", "ct_backward",
       "forward_ep", "input_grad_ep", "backward_ep", "ct_backward_ep")


def backend_of_ops(name: str, make: Callable, *,
                   graphable: bool = True) -> ConvBackend:
    """A `ConvBackend` named `name` whose op `op` is `make(op)`, for every
    op of OPS (the wrappers `fallback_backend` and
    `serve.faults.inject_backend` build)."""
    return ConvBackend(name, graphable=graphable, **{
        op if op in OPS[:3] else f"fused_{op}": make(op) for op in OPS})


_BACKENDS: Dict[str, ConvBackend] = {}


def register_backend(backend: ConvBackend) -> ConvBackend:
    _BACKENDS[backend.name] = backend
    return backend


def available_backends() -> tuple[str, ...]:
    _ensure_default_backends()
    return tuple(sorted(_BACKENDS))


def resolve_backend(backend: BackendLike) -> ConvBackend:
    """Name / bool / None / ConvBackend / sequence-of-those ->
    ConvBackend.  A tuple or list resolves through `fallback_backend`."""
    _ensure_default_backends()
    if isinstance(backend, ConvBackend):
        return backend
    if isinstance(backend, (tuple, list)):
        return fallback_backend(tuple(backend))
    if isinstance(backend, bool):     # `repro`'s legacy use_pallas flag
        name = "cuda" if backend else "torch_zero_free"
    else:
        name = DEFAULT_BACKEND if backend is None else backend
    if not isinstance(name, str):
        raise TypeError(f"backend must be a name, a bool, None, a "
                        f"ConvBackend or a sequence of those, got "
                        f"{type(backend).__name__}")
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown conv backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


# ---------------------------------------------------------------------------
# Graceful degradation: a fallback ladder over backends.  `ConvServeEngine`
# drives its per-bucket ladder itself (it keeps breaker state around each
# rung); this is the same seam for every other call site.
# ---------------------------------------------------------------------------

def may_degrade(exc: BaseException, on_card: bool) -> bool:
    """May a ladder degrade past a rung that raised `exc`?  On the CPU
    always.  On the card only for an `InjectedFault`, which is raised
    before anything is launched: any other exception (a kernel fault, a
    failed build, a CUDA error, a plan or dtype refusal) must surface
    from the rung that raised it, as a plain rung must not stand in for a
    kernel that failed and nothing may run on a context it may have
    broken.  An injected exception is marked by its class's `injected`
    attribute (`serve.faults.InjectedFault` sets it), so this layer
    needs nothing of the serving layer."""
    return not on_card or bool(getattr(type(exc), "injected", False))


_FALLBACK_CACHE: Dict[tuple, ConvBackend] = {}


def fallback_backend(chain: Sequence[BackendLike], *,
                     on_fallback: Optional[Callable] = None) -> ConvBackend:
    """A `ConvBackend` that tries each backend in `chain` in order.

    Every op (plain, fused, and epilogue-fused) attempts the rungs left
    to right; an exception from rung i that `may_degrade` allows -- on
    the operands' device -- invokes ``on_fallback(backend_name, op_name,
    exc)`` (when given) and falls through to rung i+1.  Any other
    exception propagates at once.  When every rung fails the LAST
    exception propagates: the ladder never swallows a total failure.

    Ladders of names (and bools / None) without an `on_fallback`
    observer are memoized per chain, so repeated
    `resolve_backend(("cuda", "reference"))` calls return the SAME object
    and `dispatch_backend`'s `_SHARDED_CACHE` (keyed on `id(base)`) stays
    effective under a mesh.  A chain holding a `ConvBackend` object is
    built afresh each time: the memo never keeps such objects alive."""
    entries: Tuple[BackendLike, ...] = tuple(chain)
    if not entries:
        raise ValueError("fallback chain must name at least one backend")

    cache_key = None
    if on_fallback is None and all(isinstance(e, (str, bool, type(None)))
                                   for e in entries):
        cache_key = entries
        hit = _FALLBACK_CACHE.get(cache_key)
        if hit is not None:
            return hit

    backends = tuple(resolve_backend(b) for b in entries)

    # Each op calls the rung's own METHOD (not its raw fused slot): a rung
    # without a fused kernel contributes its two-launch composition
    # instead of being skipped.
    def rung_by_rung(op_name):
        def op(*args):
            on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                          for a in args)
            last_exc = None
            for be in backends:
                try:
                    return getattr(be, op_name)(*args)
                except Exception as exc:  # noqa: BLE001 - the ladder's rule
                    if not may_degrade(exc, on_card):
                        raise
                    last_exc = exc
                    if on_fallback is not None:
                        on_fallback(be.name, op_name, exc)
            raise last_exc
        return op

    ladder = backend_of_ops(">".join(be.name for be in backends),
                            rung_by_rung,
                            graphable=all(be.graphable for be in backends))
    if cache_key is not None:
        _FALLBACK_CACHE[cache_key] = ladder
    return ladder


# ---------------------------------------------------------------------------
# Default backends, registered lazily (core.ecoflow / kernels import this
# module for ConvSpec).
# ---------------------------------------------------------------------------

_DEFAULTS_REGISTERED = False


def _ensure_default_backends() -> None:
    global _DEFAULTS_REGISTERED
    if _DEFAULTS_REGISTERED:
        return

    from repro_torch.core import ecoflow
    from repro_torch.kernels import ops as kops

    # -- reference: autograd's own F.conv2d derivatives (materializes the
    # dilation zeros); torch.nn.grad runs the convolution_backward that
    # autograd runs for F.conv2d, and stays differentiable itself.
    def _ref_forward(x, w, spec: ConvSpec):
        return ecoflow.direct_conv(x, w, spec.stride, spec.padding,
                                   dilation=spec.dilation)

    def _ref_input_grad(dy, w, spec: ConvSpec, n_out):
        nh, nw = _pair(n_out)
        dx = torch.nn.grad.conv2d_input(
            (dy.shape[0], w.shape[2], nh, nw), w.permute(3, 2, 0, 1),
            dy.permute(0, 3, 1, 2), stride=spec.stride,
            padding=spec.padding, dilation=spec.dilation)
        return dx.permute(0, 2, 3, 1).contiguous()

    def _ref_filter_grad(x, dy, spec: ConvSpec):
        kh, kw = spec.filter_shape
        dw = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (dy.shape[3], x.shape[3], kh, kw),
            dy.permute(0, 3, 1, 2), stride=spec.stride,
            padding=spec.padding, dilation=spec.dilation)
        return dw.permute(2, 3, 1, 0).contiguous()

    register_backend(ConvBackend("reference", _ref_forward,
                                 _ref_input_grad, _ref_filter_grad))

    # -- torch_zero_free: EcoFlow phase/tap decomposition in dense ops -----
    def _tzf_forward(x, w, spec: ConvSpec):
        if spec.dilation == (1, 1):
            return _ref_forward(x, w, spec)
        return ecoflow.dilated_forward_zero_free(
            x, w, stride=spec.stride, padding=spec.padding,
            dilation=spec.dilation)

    def _tzf_input_grad(dy, w, spec: ConvSpec, n_out):
        return ecoflow.transposed_conv_zero_free(
            dy, w, stride=spec.stride, padding=spec.padding,
            n_out=_pair(n_out), dilation=spec.dilation)

    def _tzf_filter_grad(x, dy, spec: ConvSpec):
        return ecoflow.dilated_conv_filter_grad_zero_free(
            x, dy, stride=spec.stride, padding=spec.padding,
            k=spec.filter_shape, dilation=spec.dilation)

    register_backend(ConvBackend("torch_zero_free", _tzf_forward,
                                 _tzf_input_grad, _tzf_filter_grad))

    # -- cuda: the hand-written kernels --------------------------------------
    def _cuda_forward(x, w, spec: ConvSpec):
        # The plain 1x1, S=1, P=0, D=1 conv is a plain matrix product,
        # which `repro` leaves to XLA; every other plain forward takes
        # the dconv_forward kernel with no epilogue.
        if (spec.filter_shape == (1, 1) and spec.stride == (1, 1)
                and spec.padding == (0, 0) and spec.dilation == (1, 1)):
            return torch.matmul(x, w[0, 0])
        return kops.dconv_forward(x, w, stride=spec.stride,
                                  padding=spec.padding,
                                  dilation=spec.dilation)

    def _cuda_input_grad(dy, w, spec: ConvSpec, n_out):
        return kops.tconv_phase(dy, w, stride=spec.stride,
                                padding=spec.padding, n_out=_pair(n_out),
                                dilation=spec.dilation)

    # A forward with an epilogue always takes the kernel (dilation 1
    # included), so the tail is fused into the single conv launch.
    def _cuda_forward_ep(x, w, bias, spec: ConvSpec, ep: Epilogue):
        return kops.dconv_forward(x, w, stride=spec.stride,
                                  padding=spec.padding,
                                  dilation=spec.dilation,
                                  bias=bias, epilogue=ep)

    def _cuda_input_grad_ep(dy, w, bias, spec: ConvSpec, n_out,
                            ep: Epilogue):
        return kops.tconv_phase(dy, w, stride=spec.stride,
                                padding=spec.padding, n_out=_pair(n_out),
                                dilation=spec.dilation,
                                bias=bias, epilogue=ep)

    def _cuda_filter_grad(x, dy, spec: ConvSpec):
        return kops.dconv_filter_grad(x, dy, stride=spec.stride,
                                      padding=spec.padding,
                                      k=spec.filter_shape,
                                      dilation=spec.dilation)

    # The fused dual-gradient backwards: ONE launch per conv VJP, (dx, dW)
    # from one kernel that reads dy once; with an epilogue the same launch
    # masks the cotangent with act'(y) and gives db.
    def _cuda_backward(x, dy, w, spec: ConvSpec, n_out):
        return kops.conv_backward(x, dy, w, stride=spec.stride,
                                  padding=spec.padding, n_out=_pair(n_out),
                                  dilation=spec.dilation)

    def _cuda_ct_backward(g, dy, w, spec: ConvSpec):
        return kops.tconv_backward(g, dy, w, stride=spec.stride,
                                   padding=spec.padding,
                                   dilation=spec.dilation)

    def _cuda_backward_ep(x, y, dy, w, spec: ConvSpec, n_out, ep: Epilogue):
        return kops.conv_backward(x, dy, w, stride=spec.stride,
                                  padding=spec.padding, n_out=_pair(n_out),
                                  dilation=spec.dilation, y=y, epilogue=ep)

    def _cuda_ct_backward_ep(g, z, dy, w, spec: ConvSpec, ep: Epilogue):
        return kops.tconv_backward(g, dy, w, stride=spec.stride,
                                   padding=spec.padding,
                                   dilation=spec.dilation, z=z, epilogue=ep)

    register_backend(ConvBackend(
        "cuda", _cuda_forward, _cuda_input_grad, _cuda_filter_grad,
        fused_backward=_cuda_backward,
        fused_ct_backward=_cuda_ct_backward,
        fused_forward_ep=_cuda_forward_ep,
        fused_input_grad_ep=_cuda_input_grad_ep,
        fused_backward_ep=_cuda_backward_ep,
        fused_ct_backward_ep=_cuda_ct_backward_ep))

    _DEFAULTS_REGISTERED = True


# ---------------------------------------------------------------------------
# Sharding-aware dispatch: per-shard launches on a multi-rank mesh
# ---------------------------------------------------------------------------

def dispatch_backend(backend: BackendLike) -> ConvBackend:
    """Mesh-aware `resolve_backend`.

    Outside a `repro_torch.parallel.sharding.use_mesh` context (or on a
    1-rank mesh) this IS `resolve_backend`.  Under a multi-rank mesh it
    wraps the resolved backend so every conv op runs on each rank's
    blocks: batch over the logical "dp" axes, channels over "tp",
    explicit all-reduces for the reduced gradients.  The mesh is read
    at every op."""
    be = resolve_backend(backend)
    mesh = current_mesh()
    if mesh is None or mesh_size(mesh) <= 1:
        return be
    return sharded_backend(be, mesh)


_SHARDED_CACHE: Dict[tuple, ConvBackend] = {}


def sharded_backend(base: ConvBackend, mesh) -> ConvBackend:
    """The per-shard wrapper of `base` on `mesh` (memoized per pair).

    Per-op scheme -- no forward-path all-reduce is ever needed, which
    keeps nonlinear epilogues exact (only NON-contracted dims shard):

      forward / forward_ep       x:(B@dp,..)  w:(..,Cin,Cout@tp) -> y@(dp,tp)
      input_grad / _ep (tconv)   dy:(B@dp,..) w:(..,Cin@tp,Cout) -> dx@(dp,tp)
      backward / backward_ep     per-shard fused launch, then
                                 psum(dx, tp) + psum(dW/db, dp)
      ct_backward / _ep          per-shard fused launch, then
                                 psum(ddy, tp) + psum(dW/db, dp)
      filter_grad                psum(dW, dp)

    Each axis applies only when it divides the corresponding global dim
    (`parallel.sharding._guard`'s policy).  The operands may be DTensors
    in any layout, or plain tensors whole on every rank; each is moved to
    the op's layout (`sharding.local`), the base backend runs on the
    blocks, and its outputs come back as DTensors of the out layout (a
    plain result when no operand is a DTensor and nothing shards).  So
    the base backend's own choices -- the fused-vs-two-launch fallback,
    `kernels/tiling.py`'s plans, the phase / implicit-GEMM race -- see
    LOCAL shapes: one forward and one backward launch per shard.  The
    collectives run outside the kernel launches; the conv Functions
    (`core/conv.py`) lay each gradient out as its input."""
    key = (id(base), id(mesh))
    hit = _SHARDED_CACHE.get(key)
    if hit is not None:
        return hit

    from repro_torch.parallel import sharding as sh

    la = sh.logical_axes(mesh)
    dp_axes, tp_axes = la["dp"], la["tp"]

    def _ax(axes, dim):
        """`axes` if it is real (> 1 rank) and divides `dim`."""
        if axes is None:
            return None
        n = sh._axis_size(mesh, axes)
        return axes if n > 1 and dim % n == 0 else None

    def _launch(body, in_specs, out_specs, *args):
        """shard_map: `body` on each arg's block under its spec; the
        outputs wrapped by `out_specs` (a list for several)."""
        if not any(sh.is_dtensor(a) for a in args) and not any(
                e is not None for s in in_specs for e in s):
            return body(*args)
        out = body(*[sh.local(a, mesh, s) for a, s in zip(args, in_specs)])
        if isinstance(out_specs, list):
            return tuple(sh.from_local(o, mesh, s)
                         for o, s in zip(out, out_specs))
        return sh.from_local(out, mesh, out_specs)

    def _psum(v, axes):
        return sh.psum(v, mesh, axes)

    X = (None, None, None)

    # -- forward family: shard the produced dims, contract full ones ------

    def forward(x, w, spec):
        bd, cd = _ax(dp_axes, x.shape[0]), _ax(tp_axes, w.shape[3])
        return _launch(lambda x_, w_: base.forward(x_, w_, spec),
                       [(bd,) + X, X + (cd,)], (bd, None, None, cd), x, w)

    def forward_ep(x, w, bias, spec, ep):
        bd, cd = _ax(dp_axes, x.shape[0]), _ax(tp_axes, w.shape[3])
        if bias is None:
            return _launch(
                lambda x_, w_: base.forward_ep(x_, w_, None, spec, ep),
                [(bd,) + X, X + (cd,)], (bd, None, None, cd), x, w)
        return _launch(
            lambda x_, w_, b_: base.forward_ep(x_, w_, b_, spec, ep),
            [(bd,) + X, X + (cd,), (cd,)], (bd, None, None, cd),
            x, w, bias)

    # tconv-as-a-layer: the produced channel dim is Cin (w.shape[2]); the
    # contracted Cout stays whole per shard, so the epilogue bias (a
    # per-Cin vector here) applies to exact sums.

    def input_grad(dy, w, spec, n_out):
        bd, cd = _ax(dp_axes, dy.shape[0]), _ax(tp_axes, w.shape[2])
        return _launch(
            lambda dy_, w_: base.input_grad(dy_, w_, spec, n_out),
            [(bd,) + X, (None, None, cd, None)], (bd, None, None, cd),
            dy, w)

    def input_grad_ep(dy, w, bias, spec, n_out, ep):
        bd, cd = _ax(dp_axes, dy.shape[0]), _ax(tp_axes, w.shape[2])
        if bias is None:
            return _launch(
                lambda dy_, w_: base.input_grad_ep(dy_, w_, None, spec,
                                                   n_out, ep),
                [(bd,) + X, (None, None, cd, None)], (bd, None, None, cd),
                dy, w)
        return _launch(
            lambda dy_, w_, b_: base.input_grad_ep(dy_, w_, b_, spec,
                                                   n_out, ep),
            [(bd,) + X, (None, None, cd, None), (cd,)],
            (bd, None, None, cd), dy, w, bias)

    # -- backward family: per-shard fused launch + explicit psums ---------
    # dx / ddy are partial over the sharded channel dim (tp); dW / db are
    # partial over the batch shards (dp).  The psums follow the launch,
    # so each conv layer is still one backward launch per shard.

    def filter_grad(x, dy, spec):
        bd, cd = _ax(dp_axes, x.shape[0]), _ax(tp_axes, dy.shape[3])
        return _launch(
            lambda x_, dy_: _psum(base.filter_grad(x_, dy_, spec), bd),
            [(bd,) + X, (bd, None, None, cd)], X + (cd,), x, dy)

    def backward(x, dy, w, spec, n_out):
        bd, cd = _ax(dp_axes, x.shape[0]), _ax(tp_axes, w.shape[3])

        def body(x_, dy_, w_):
            dx, dw = base.backward(x_, dy_, w_, spec, n_out)
            return _psum(dx, cd), _psum(dw, bd)

        return _launch(body, [(bd,) + X, (bd, None, None, cd), X + (cd,)],
                       [(bd,) + X, X + (cd,)], x, dy, w)

    def backward_ep(x, y, dy, w, spec, n_out, ep):
        bd, cd = _ax(dp_axes, x.shape[0]), _ax(tp_axes, w.shape[3])

        def body(x_, dy_, w_, *rest):
            y_ = rest[0] if ep.needs_y else None
            dx, dw, db = base.backward_ep(x_, y_, dy_, w_, spec, n_out, ep)
            dx, dw = _psum(dx, cd), _psum(dw, bd)
            if db is None:
                return dx, dw
            return dx, dw, _psum(db, bd)

        in_specs = [(bd,) + X, (bd, None, None, cd), X + (cd,)]
        args = [x, dy, w]
        if ep.needs_y:
            in_specs.append((bd, None, None, cd))
            args.append(y)
        out_specs = [(bd,) + X, X + (cd,)] + ([(cd,)] if ep.bias else [])
        out = _launch(body, in_specs, out_specs, *args)
        return out if ep.bias else (out[0], out[1], None)

    def ct_backward(g, dy, w, spec):
        bd, cd = _ax(dp_axes, g.shape[0]), _ax(tp_axes, w.shape[2])

        def body(g_, dy_, w_):
            ddy, dw = base.ct_backward(g_, dy_, w_, spec)
            return _psum(ddy, cd), _psum(dw, bd)

        return _launch(body, [(bd, None, None, cd), (bd,) + X,
                              (None, None, cd, None)],
                       [(bd,) + X, (None, None, cd, None)], g, dy, w)

    def ct_backward_ep(g, z, dy, w, spec, ep):
        bd, cd = _ax(dp_axes, g.shape[0]), _ax(tp_axes, w.shape[2])

        def body(g_, dy_, w_, *rest):
            z_ = rest[0] if ep.needs_y else None
            ddy, dw, db = base.ct_backward_ep(g_, z_, dy_, w_, spec, ep)
            ddy, dw = _psum(ddy, cd), _psum(dw, bd)
            if db is None:
                return ddy, dw
            return ddy, dw, _psum(db, bd)

        in_specs = [(bd, None, None, cd), (bd,) + X, (None, None, cd, None)]
        args = [g, dy, w]
        if ep.needs_y:
            in_specs.append((bd, None, None, cd))
            args.append(z)
        out_specs = [(bd,) + X, (None, None, cd, None)] + \
            ([(cd,)] if ep.bias else [])
        out = _launch(body, in_specs, out_specs, *args)
        return out if ep.bias else (out[0], out[1], None)

    wrapped = ConvBackend(
        name=f"{base.name}@shard",
        forward=forward,
        input_grad=input_grad,
        filter_grad=filter_grad,
        # Every fused slot is filled so the ConvBackend methods always
        # route here; the base backend's own fused-vs-two-launch choice
        # happens on the blocks.
        fused_backward=backward,
        fused_ct_backward=ct_backward,
        fused_forward_ep=forward_ep,
        fused_input_grad_ep=input_grad_ep,
        fused_backward_ep=backward_ep,
        fused_ct_backward_ep=ct_backward_ep,
        graphable=base.graphable)
    _SHARDED_CACHE[key] = wrapped
    return wrapped
