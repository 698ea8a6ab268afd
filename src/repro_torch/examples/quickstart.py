"""Quickstart: EcoFlow's zero-free transposed / dilated convolutions
(counterpart of `examples/quickstart.py`).

Shows the paper's core contribution end to end on one layer:
  1. how much of the naive backward pass is multiplications by zero,
  2. that the zero-free dataflows compute the gradients of the plain
     conv: on the `cuda` backend its `input_grad` slot (the transposed-conv
     kernels) and its `filter_grad` slot (the standalone zero-free dW
     kernel), against autograd and the materialized-zero baselines,
  3. the compile-time mapping (symbolic outer product -> PE schedules)
     functionally simulated on a PE-array model,
  4. the time of zero-free against materialized-zero on this device: the
     hand kernel, the zero-free dense ops (`torch_zero_free`) and
     `naive` (zero insertion plus one cuDNN call), with CUDA events on
     the card (beside its name and power limit),
  5. a drop-in training conv whose backward is zero-free.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without `--device` it runs on the card (and fails without one).  On the
card TF32 is off for the run, so every side computes in fp32.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import ecoflow, mapping, naive
from repro_torch.core.conv import ecoflow_conv
from repro_torch.core.spec import ConvSpec, resolve_backend
from repro_torch.device import resolve_device

# A resnet50-CONV3-like layer: 3x3 filter, stride 2.
B, N, K, S, Ci, Co = 4, 57, 3, 2, 16, 16
P = 1
O = (N + 2 * P - K) // S + 1
ARMS = ("kernel", "torch_zero_free", "naive")
ITERS = 20                   # calls per timing of section 4
SPIN_CYCLES = 50_000_000     # ~25 ms at the H100's clock: holds the stream


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def time_ms(fn, dev: torch.device, iters: int) -> float:
    """Mean ms of `fn()` over `iters` calls after one warm-up: on the card
    CUDA events around the calls, queued behind a sleep kernel so that
    the host's launch overhead is not in the device time; on the CPU the
    host clock."""
    fn()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> dict:
    """Run the five sections; return what they computed: the zero-MAC
    fractions, every gradient (and the largest errors), the mapping's
    check, the arms' ms and the drop-in conv's gradients."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _run(dev: torch.device) -> dict:
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    x, w, dy = draw(B, N, N, Ci), draw(K, K, Ci, Co), draw(B, O, O, Co)
    spec = ConvSpec.make(stride=S, padding=P, filter_shape=K)
    cuda, tzf = resolve_backend("cuda"), resolve_backend("torch_zero_free")
    res = {"device": device_line(dev)}

    print("== 1. padding-induced zero MACs (paper Fig. 3) ==")
    print(f"layer: ifmap {N}x{N}, filter {K}x{K}, stride {S} -> error "
          f"{O}x{O}")
    res["zero_mac_fraction"] = {
        "input_grad": ecoflow.tconv_zero_mac_fraction(O, K, S),
        "filter_grad": ecoflow.dconv_zero_mac_fraction(O, S)}
    print(f"input-grad  zero-MAC fraction: "
          f"{res['zero_mac_fraction']['input_grad']:.1%}")
    print(f"filter-grad zero-MAC fraction: "
          f"{res['zero_mac_fraction']['filter_grad']:.1%}")

    print("\n== 2. zero-free gradients (cuda backend) == autograd of the "
          "plain conv ==")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx_ref, dw_ref = torch.autograd.grad(
        ecoflow.direct_conv(xr, wr, S, P), (xr, wr), dy)
    with torch.no_grad():
        dx = cuda.input_grad(dy, w, spec, (N, N))
        dw = cuda.filter_grad(x, dy, spec)
        dx_naive = naive.transposed_conv_naive(dy, w, stride=S, padding=P,
                                               n_out=(N, N))
        dw_naive = naive.dilated_conv_filter_grad_naive(x, dy, stride=S,
                                                        padding=P, k=(K, K))
    res["grads"] = {"dx": dx, "dw": dw, "dx_ref": dx_ref, "dw_ref": dw_ref,
                    "dx_naive": dx_naive, "dw_naive": dw_naive}
    res["max_abs_err"] = {
        "dx_vs_autograd": (dx - dx_ref).abs().max().item(),
        "dw_vs_autograd": (dw - dw_ref).abs().max().item(),
        "dx_vs_naive": (dx - dx_naive).abs().max().item(),
        "dw_vs_naive": (dw - dw_naive).abs().max().item()}
    for name, err in res["max_abs_err"].items():
        print(f"max |{name.replace('_vs_', ' - ')}| = {err:.3e}")

    print("\n== 3. the paper's compile-time mapping, simulated on a PE "
          "array ==")
    m = mapping.build_tconv_mapping(err_n=2, k=3, stride=2)   # Fig. 5
    err2 = rng.normal(size=(2, 2))
    w2 = rng.normal(size=(3, 3))
    out = mapping.simulate_tconv(m, err2, w2)
    full = np.zeros((m.out_n, m.out_n))
    for i in range(2):
        for j in range(2):
            full[2 * i:2 * i + 3, 2 * j:2 * j + 3] += err2[i, j] * w2
    res["mapping_ok"] = bool(np.allclose(out, full))
    print(f"PE array {m.pe_rows}x{m.pe_cols}, useful MACs "
          f"{m.n_useful_macs}, schedule {m.cycle_count()} cycles")
    print("mapping == ground truth:", res["mapping_ok"])

    print(f"\n== 4. time: zero-free vs materialized-zero ({res['device']}) "
          f"==")
    runs = {
        "input_grad": {
            "kernel": lambda: cuda.input_grad(dy, w, spec, (N, N)),
            "torch_zero_free": lambda: tzf.input_grad(dy, w, spec, (N, N)),
            "naive": lambda: naive.transposed_conv_naive(
                dy, w, stride=S, padding=P, n_out=(N, N))},
        "filter_grad": {
            "kernel": lambda: cuda.filter_grad(x, dy, spec),
            "torch_zero_free": lambda: tzf.filter_grad(x, dy, spec),
            "naive": lambda: naive.dilated_conv_filter_grad_naive(
                x, dy, stride=S, padding=P, k=(K, K))}}
    res["ms"] = {}
    with torch.no_grad():
        for op, arms in runs.items():
            res["ms"][op] = {arm: time_ms(fn, dev, ITERS)
                             for arm, fn in arms.items()}
            t = res["ms"][op]
            print(f"{op}: kernel {t['kernel']:.4f} ms, torch_zero_free "
                  f"{t['torch_zero_free']:.4f} ms, naive {t['naive']:.4f} ms "
                  f"-> naive / kernel {t['naive'] / t['kernel']:.2f}x")
    if dev.type == "cpu":
        print("(on the CPU the kernel arm is its plain PyTorch version)")

    print("\n== 5. drop-in training conv with EcoFlow backward (cuda "
          "backend) ==")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = (ecoflow_conv(xr, wr, S, P, "cuda") ** 2).sum()
    gx, gw = torch.autograd.grad(loss, (xr, wr))
    res["drop_in"] = {"gx": gx, "gw": gw,
                      "finite": bool(torch.isfinite(gx).all()
                                     and torch.isfinite(gw).all())}
    print("grad shapes:", tuple(gx.shape), tuple(gw.shape), "-- finite:",
          res["drop_in"]["finite"])
    return res


if __name__ == "__main__":
    main()
