"""Strategy choice for the transposed conv (reduced port of
`repro/kernels/tiling.py::plan_strategy`).

`repro` races the phase decomposition against the predicated
implicit-GEMM kernel with an analytical TPU cost model.  This port
carries a small rule in its place, which gives `repro`'s compiled-mode
(`interpret=False`) decision on the geometries the serving slice runs --
the GAN generator's three K=4, S=2, P=1 layers at any batch:

    implicit_gemm  when the transposed conv produces fewer than
                   IMPLICIT_GEMM_MAX_CIN channels (the RGB output layer,
                   Cin = 3),
    phase          otherwise (t1: Cin = 64, t2: Cin = 32).

A test pins that agreement.  The Hopper planner, a measured race on the
card, replaces the rule later.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.spec import ConvSpec, Epilogue

STRATEGIES = ("phase", "implicit_gemm")

IMPLICIT_GEMM_MAX_CIN = 8


def plan_strategy(op: str, spec: ConvSpec, *, x_shape, dy_shape,
                  epilogue: Optional[Epilogue] = None,
                  strategy: Optional[str] = None) -> str:
    """Which kernel family runs one launch: "phase" | "implicit_gemm".

    `x_shape` is the transposed conv's output (the forward input) and
    `dy_shape` its input.  `strategy` pins "phase" | "implicit_gemm" for
    this call, or "auto" (the default, None) applies the rule.  Ops other
    than the standalone "input_grad" have no implicit-GEMM kernel and
    always take "phase", pinned or not, as in `repro`.  `spec`,
    `dy_shape` and `epilogue` are part of `repro`'s signature; the rule
    reads only the produced channel count."""
    strategy = "auto" if strategy is None else strategy
    if strategy not in STRATEGIES + ("auto",):
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{STRATEGIES + ('auto',)}")
    if op != "input_grad":
        return "phase"
    if strategy != "auto":
        return strategy
    return "implicit_gemm" if x_shape[-1] < IMPLICIT_GEMM_MAX_CIN \
        else "phase"
