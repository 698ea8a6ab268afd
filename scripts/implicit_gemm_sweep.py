#!/usr/bin/env python3
"""Device time of the implicit-GEMM transposed conv (`csrc/implicit_gemm.cu`)
at the generator's layers, at the plan's tiles and, with `--sweep`, at
every tile and chunk the kernel takes: the sweep that
`kernels/implicit_gemm.py::plan`'s constants come from.

    python3 scripts/implicit_gemm_sweep.py [--sweep] [--src DIR] [--tag T]

Needs one CUDA card and `nvcc`.  The layers: gan t3 (Cin 3, the main
path) and t1, t2 (the phase / implicit-GEMM race's other arm), K = 4,
S = 2, P = 1, at the serving slot batch 4 and at batch 64.  `--sweep`
launches every plan of `implicit_gemm.candidates` (the set the planner's
autotune walks: every tile of cu x cv sites per residue class, cu, cv in
1, 2, 4, 8, 16, at most 512 threads, each class at least one warp, and
every chunk that fits), each launch held against the plain version within
1e-4 and timed with CUDA events (the least of three
`chip_smoke.DeviceTimer` readings of 20 launches), beside an empty
kernel's launch.  `--src` imports `repro_torch` from another tree (a
`git archive` of a parent commit, whose kernel may take no plan) to
time its kernel at the same layers in the same call.  One JSON line per
configuration, one `best` line per layer with the plan's own, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, batch, dy side, Cin, Cout) of the generator's transposed convs.
LAYERS = [("gan_t3_B4", 4, (16, 16), 3, 32),
          ("gan_t3_B64", 64, (16, 16), 3, 32),
          ("gan_t1_B4", 4, (4, 4), 64, 128),
          ("gan_t1_B64", 64, (4, 4), 64, 128),
          ("gan_t2_B4", 4, (8, 8), 32, 64),
          ("gan_t2_B64", 64, (8, 8), 32, 64)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("implicit_gemm_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    import chip_smoke
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import implicit_gemm as ig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    timer = chip_smoke.DeviceTimer()
    build.build(["implicit_gemm"])
    tag = args.tag

    def emit(row):
        print(json.dumps({"tag": tag} | row), flush=True)

    if hasattr(ig, "plan"):
        empty = build.kernel_function("implicit_gemm", "empty_launch",
                                      [ctypes.c_void_p])
        emit({"empty_kernel_ms": min(timer(lambda: build.check_launch(
            "implicit_gemm", empty(torch.cuda.current_stream().cuda_stream)))
            for _ in range(3))})
    gen = torch.Generator().manual_seed(0)
    ep = Epilogue(activation="tanh")
    spec = ConvSpec.make(stride=2, padding=1, filter_shape=4, dilation=1)
    for name, B, in_hw, cin, cout in LAYERS:
        n_out = spec.input_size(in_hw)
        dy = torch.randn((B, *in_hw, cout), generator=gen).to(dev)
        w = torch.randn((4, 4, cin, cout), generator=gen).to(dev)
        want = ig.tconv_implicit_gemm_plain(dy, w, spec, n_out=n_out,
                                            epilogue=ep)

        def run():
            return ops.tconv_implicit_gemm(dy, w, stride=2, padding=1,
                                           n_out=n_out, epilogue=ep)

        def timed(call=run):
            got = call()
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            return min(timer(call) for _ in range(3))

        own = ig.plan(spec, B, n_out, in_hw, cin, cout) \
            if hasattr(ig, "plan") else None
        own_ms = timed()
        emit({"layer": name, "plan": None if own is None else own._asdict(),
              "ms": own_ms})
        if not args.sweep or not hasattr(ig, "candidates"):
            continue
        best = (own_ms, own)
        for p in ig.candidates(spec, B, n_out, in_hw, cin, cout)[1:]:
            ms = timed(lambda p=p: ig.tconv_implicit_gemm_cuda(
                dy, w, spec, n_out=n_out, epilogue=ep, plan=p))
            emit({"layer": name, "plan": p._asdict(), "ms": ms})
            best = min(best, (ms, p), key=lambda t: t[0])
        emit({"best": name, "ms": best[0], "plan": best[1]._asdict(),
              "plan_ms": own_ms, "own_plan": own._asdict()})
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
