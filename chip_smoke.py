#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and the repository's `src/` beside this file;
without a card, or run from a directory that holds nothing else of the
repository, it exits non-zero and prints no result.  It imports nothing
of JAX and nothing of the JAX package `repro`.

Phases (any failed check raises and ends the run non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the three CUDA kernels of src/repro_torch/csrc (one nvcc per
     source, all at once);
  3. each kernel at the serving path's shapes (slot batch 4, and batch
     64) and at a ragged geometry with a bias and a non-exact n_out:
     held against its plain PyTorch version on the card, and at the
     path's shapes against the library call; kernel, plain and library
     timed with CUDA events;
  4. serve 32 `gan_gen` and 32 `aspp` requests at the models' published
     widths through ConvServeEngine(ladder=("cuda",)): every result held
     against the same request through the plain versions, the kernels'
     launch counts against the launches the path makes, and no fault,
     fallback or NaN allowed.

Tolerance: atol = rtol = 1e-4 everywhere.  Kernel, plain version and
library all compute in fp32; they differ only in the order of their
sums, which moves fp32 results by a few ulps of the largest partial sum.
TF32 is turned off for cuDNN and for torch.matmul, so no side rounds its
inputs to 10 bits.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 peak outside the tensor cores
SLOT_BATCH = 4
N_REQUESTS = 32


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

class DeviceTimer:
    """Device time of a call with CUDA events.  A spin kernel queued ahead
    of the timed launches holds the stream until the host has queued them
    all, so the events measure the card and not the host's launch rate."""

    def __init__(self):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.ms_per_cycle = start.elapsed_time(end) / 10_000_000

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / warmup
        cycles = int((2.0 * iters * host_ms + 1.0) / self.ms_per_cycle)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(min(cycles, 4_000_000_000))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


# -- work counts for the bound -----------------------------------------------

def _taps_in_range(o, n, k, s, p, d) -> int:
    """(output position, tap) pairs of one axis whose input index lies in
    the image: the products these inputs need (padding zeros excluded).
    The count is the same for a conv and its transposed conv."""
    return sum(1 for i in range(o) for t in range(k)
               if 0 <= i * s + t * d - p < n)


def useful_macs(spec, batch, small_hw, large_hw, cin, cout) -> int:
    """small_hw: the conv output (= tconv input) size, large_hw: the conv
    input (= tconv output) size."""
    return batch * cin * cout * math.prod(
        _taps_in_range(small_hw[a], large_hw[a], spec.filter_shape[a],
                       spec.stride[a], spec.padding[a], spec.dilation[a])
        for a in range(2))


def bound_ms(nbytes: int, macs: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.dconv_forward import dconv_forward_plain
    from repro_torch.kernels.implicit_gemm import tconv_implicit_gemm_plain
    from repro_torch.kernels.tconv_phase import tconv_fused_plain
    from repro_torch.models import gan, vision
    from repro_torch.serve.conv_engine import ConvRequest, ConvServeEngine

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off for cuDNN and torch.matmul (fp32 against fp32)")

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- phase 3: each kernel against its plain version and the library -------
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    relu, tanh = Epilogue(activation="relu"), Epilogue(activation="tanh")
    ragged_ep = Epilogue(activation="leaky_relu", slope=0.2, bias=True,
                         scale=0.5)

    def fwd_case(name, B, hw, cin, cout, k, s, p, d, ep, path):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        x, w = rand(B, *hw, cin), rand(*spec.filter_shape, cin, cout)
        bias = rand(cout) if ep.bias else None
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        oh_ow = spec.out_size(hw)
        return dict(kernel="dconv_forward", case=name, path=path,
                    run=lambda: ops.dconv_forward(
                        x, w, stride=s, padding=p, dilation=d, bias=bias,
                        epilogue=ep),
                    plain=lambda: dconv_forward_plain(x, w, spec, bias=bias,
                                                      epilogue=ep),
                    lib=lambda: ep.apply(F.conv2d(
                        x.permute(0, 3, 1, 2), w_lib, bias=None,
                        stride=spec.stride, padding=spec.padding,
                        dilation=spec.dilation).permute(0, 2, 3, 1), bias),
                    macs=useful_macs(spec, B, oh_ow, hw, cin, cout),
                    nbytes=4 * (x.numel() + w.numel()
                                + (cout if bias is not None else 0)
                                + B * oh_ow[0] * oh_ow[1] * cout))

    def tconv_case(kernel, name, B, in_hw, n_out, cin, cout, k, s, p, d, ep,
                   path):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        assert spec.out_size(n_out) == tuple(in_hw), (name, n_out)
        dy, w = rand(B, *in_hw, cout), rand(*spec.filter_shape, cin, cout)
        bias = rand(cin) if ep.bias else None
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        strategy = "implicit_gemm" if kernel == "tconv_implicit_gemm" \
            else "phase"
        plain = tconv_implicit_gemm_plain if kernel == "tconv_implicit_gemm" \
            else tconv_fused_plain
        exact = spec.input_size(in_hw)
        out_pad = tuple(n_out[a] - exact[a] for a in range(2))
        return dict(kernel=kernel, case=name, path=path,
                    run=lambda: ops.tconv_phase(
                        dy, w, stride=s, padding=p, n_out=n_out, dilation=d,
                        bias=bias, epilogue=ep, strategy=strategy),
                    plain=lambda: plain(dy, w, spec, n_out=n_out, bias=bias,
                                        epilogue=ep),
                    lib=lambda: ep.apply(F.conv_transpose2d(
                        dy.permute(0, 3, 1, 2), w_lib, stride=spec.stride,
                        padding=spec.padding, output_padding=out_pad,
                        dilation=spec.dilation).permute(0, 2, 3, 1), bias),
                    macs=useful_macs(spec, B, in_hw, n_out, cin, cout),
                    nbytes=4 * (dy.numel() + w.numel()
                                + (cin if bias is not None else 0)
                                + B * n_out[0] * n_out[1] * cin))

    cases = []
    for B in (SLOT_BATCH, 64):
        path = B == SLOT_BATCH
        for r in (1, 2, 4):   # ASPP branches: 3x3, S=1, P=D=r, 3 -> 16
            cases.append(fwd_case(f"aspp_rate{r}_B{B}", B, (128, 128), 3, 16,
                                  3, 1, r, r, relu, path))
        # Generator layers t1, t2 (phase) and t3 (implicit GEMM).
        cases.append(tconv_case("tconv_phase", f"gan_t1_B{B}", B, (4, 4),
                                (8, 8), 64, 128, 4, 2, 1, 1, relu, path))
        cases.append(tconv_case("tconv_phase", f"gan_t2_B{B}", B, (8, 8),
                                (16, 16), 32, 64, 4, 2, 1, 1, relu, path))
        cases.append(tconv_case("tconv_implicit_gemm", f"gan_t3_B{B}", B,
                                (16, 16), (32, 32), 3, 32, 4, 2, 1, 1, tanh,
                                path))
    # Ragged geometries: bias fills, non-exact n_out, residues no tap
    # reaches (S=3 > K=2), stride and dilation sharing a factor.
    cases.append(fwd_case("ragged_fwd", 3, (37, 29), 5, 7, (3, 2), (2, 1),
                          (1, 2), (2, 3), ragged_ep, False))
    for kernel in ("tconv_phase", "tconv_implicit_gemm"):
        cases.append(tconv_case(kernel, "ragged_s3k2", 3, (5, 6), (14, 12),
                                5, 7, (2, 3), (3, 2), (1, 1), 1, ragged_ep,
                                False))
        cases.append(tconv_case(kernel, "ragged_s2d2", 2, (6, 5), (14, 14),
                                4, 6, 3, 2, 1, (2, 3), ragged_ep, False))

    timer = DeviceTimer()
    kernels = {}
    for c in cases:
        got = c["run"]()
        torch.cuda.synchronize()
        plain = c["plain"]()
        err = (got - plain).abs().max().item()
        if not (got.shape == plain.shape
                and torch.allclose(got, plain, atol=TOL, rtol=TOL)):
            raise AssertionError(f"{c['kernel']} {c['case']}: max |err| "
                                 f"{err:.3e} against the plain version")
        row = dict(kernel=c["kernel"], case=c["case"], max_abs_err=err)
        if c["path"] or c["case"].endswith("_B64"):
            lib = c["lib"]
            lib_out = lib()
            lib_err = (got - lib_out).abs().max().item()
            if not torch.allclose(got, lib_out, atol=TOL, rtol=TOL):
                raise AssertionError(f"{c['kernel']} {c['case']}: max |err| "
                                     f"{lib_err:.3e} against the library")
            b_ms, b_by = bound_ms(c["nbytes"], c["macs"])
            row.update(lib_err=lib_err, ms=timer(c["run"]),
                       plain_ms=timer(c["plain"]), library_ms=timer(lib),
                       bound_ms=b_ms, bound_by=b_by, macs=c["macs"],
                       nbytes=c["nbytes"])
        print("case " + json.dumps(row))
        k = kernels.setdefault(c["kernel"], dict(
            name=c["kernel"], max_abs_err=0.0, ms=0.0, plain_ms=0.0,
            library_ms=0.0, bound_ms=0.0, by={"bytes": 0.0,
                                               "operations": 0.0}))
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if c["path"]:   # one served slot batch: sum over its launches
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                k[key] += row[key]
            k["by"][row["bound_by"]] += row["bound_ms"]
    print("kernels: all three agree with their plain versions within "
          f"{TOL:g} at every case")

    # -- phase 4: serve at the published widths --------------------------------
    gen = torch.Generator().manual_seed(1234)
    gp = gan.generator_init(gen, device=dev)          # z 64, base 64, RGB
    ap = vision.atrous_head_init(gen, device=dev)     # 3 -> 16, 4 classes
    eng = ConvServeEngine(gan_params=gp, aspp_params=ap,
                          slot_batch=SLOT_BATCH, queue_limit=2 * N_REQUESTS,
                          ladder=("cuda",), device=dev)
    img = (128, 128, 3)
    eng.warmup([("gan_gen", (64,)), ("aspp", img)], compile=True)
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(N_REQUESTS):
        reqs.append(ConvRequest(None, "gan_gen",
                                rng.standard_normal(64).astype(np.float32)))
        reqs.append(ConvRequest(None, "aspp",
                                rng.standard_normal(img).astype(np.float32)))
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    batches = -(-N_REQUESTS // SLOT_BATCH)
    expect = {"tconv_phase": 2 * batches, "tconv_implicit_gemm": batches,
              "dconv_forward": 3 * batches}
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    h = eng.health()
    bad = {k: h[k] for k in ("kernel_faults", "fallbacks", "failures",
                             "nan_events", "sheds", "deadline_misses")
           if h[k]}
    if bad or h["completed"] != h["submitted"] or len(res) != len(reqs):
        raise AssertionError(f"serving was not clean: {bad}, completed "
                             f"{h['completed']} of {h['submitted']}")
    cpu = torch.device("cpu")
    with torch.no_grad():
        for kind, fn, params in (
                ("gan_gen", gan.generator_apply, gp),
                ("aspp", vision.atrous_head_apply, ap)):
            sel = [r for r in reqs if r.kind == kind]
            batch = torch.from_numpy(np.stack([r.payload for r in sel]))
            plain = fn({k: v.to(cpu) for k, v in params.items()}, batch,
                       backend="cuda").numpy()
            for r, want in zip(sel, plain):
                got = res[r.uid]
                if not (got.shape == want.shape and np.all(np.isfinite(got))
                        and np.allclose(got, want, atol=TOL, rtol=TOL)):
                    raise AssertionError(
                        f"{kind} request {r.uid}: max |err| "
                        f"{np.abs(got - want).max():.3e} against the plain "
                        f"versions")
    print(f"serve: {len(res)} requests ({N_REQUESTS} gan_gen 32x32x3, "
          f"{N_REQUESTS} aspp 128x128x3 -> 4 classes), slot batch "
          f"{SLOT_BATCH}, ladder ('cuda',): all equal the plain versions "
          f"within {TOL:g}")
    print("launches " + json.dumps(launches))
    print("health " + json.dumps({
        k: h[k] for k in ("submitted", "completed", "launches", "p50_us",
                          "p99_us", "kernel_faults", "fallbacks",
                          "failures", "nan_events")}
        | {"requests_per_s": len(res) / wall, "card": card}))

    rows = []
    for name in ("dconv_forward", "tconv_phase", "tconv_implicit_gemm"):
        k = kernels[name]
        source = {"dconv_forward": "dconv_forward.cu",
                  "tconv_phase": "tconv_phase.cu",
                  "tconv_implicit_gemm": "implicit_gemm.cu"}[name]
        replaces = {
            "dconv_forward": "src/repro/kernels/dconv_forward.py:104",
            "tconv_phase": "src/repro/kernels/tconv_phase.py:263",
            "tconv_implicit_gemm": "src/repro/kernels/implicit_gemm.py:147",
        }[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": max(k["by"], key=k["by"].get),
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(card)        # exactly as nvidia-smi gives name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
