#!/usr/bin/env python3
"""Device time of the conv kernels on the tiled implicit-GEMM engine at
the main-path layers, for each tile and split count the kernels take: the
sweep that `kernels/dconv_backward.py::plan`'s constants come from.

    python3 scripts/backward_plan_sweep.py [--ops all|backward|forward]
                                           [--layers all|main|vision]
                                           [--out FILE]

Needs one CUDA card and `nvcc`.  The backwards at the nine layers of
conv training (batch 64) and at the vision layers (patchify, the atrous
head's 1x1 fuse; `backward_roles.VISION_LAYERS`, where the candidates
include the patch roles at every split pair), and the forwards (`tconv_phase`,
`dconv_forward`) at the generator's t1 and t2 and the ASPP branches at
the serving slot batch 4 and at t1, t2, discriminator c1-c3 and CNN l1-l3
at batch 64, each launched at every plan of `dconv_backward.candidates`
(the set the planner's autotune walks): the dx / ddy tile the plan takes
for that N (a forward also at 128 x 32 or 256 x 16 when N > 4), the dW
tiles 64 x 32 and (at Cout > 32) 64 x 64, and every split count of
{1, 2, 4, 8, 16} (dx / ddy) x {4, 8, 16, 32, 64} (dW) that leaves no
split empty.  Each
launch is checked against the plan's own within 1e-4 and timed with CUDA
events (the least of three `chip_smoke.DeviceTimer` readings of 20
launches).  One JSON line per configuration, one `best` line per layer
(with the plan's own time and configuration), then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from backward_roles import layer_rows  # noqa: E402

# The forwards' layers: (op, name, batch, input side (H, W) -- dy for
# tconv_phase, x for dconv_forward -- Cin, Cout, K, S, P = D for the ASPP
# branches or P with D = 1, activation).
FORWARD_LAYERS = [
    ("tconv_phase", "gan_t1_B4", 4, (4, 4), 64, 128, 4, 2, 1, "relu"),
    ("tconv_phase", "gan_t2_B4", 4, (8, 8), 32, 64, 4, 2, 1, "relu"),
    ("dconv_forward", "aspp_rate1_B4", 4, (128, 128), 3, 16, 3, 1, 1,
     "relu"),
    ("dconv_forward", "aspp_rate2_B4", 4, (128, 128), 3, 16, 3, 1, 2,
     "relu"),
    ("dconv_forward", "aspp_rate4_B4", 4, (128, 128), 3, 16, 3, 1, 4,
     "relu"),
    ("tconv_phase", "gan_t1_B64", 64, (4, 4), 64, 128, 4, 2, 1, "relu"),
    ("tconv_phase", "gan_t2_B64", 64, (8, 8), 32, 64, 4, 2, 1, "relu"),
    ("dconv_forward", "disc_c1_B64", 64, (32, 32), 3, 32, 4, 2, 1,
     "leaky_relu"),
    ("dconv_forward", "disc_c2_B64", 64, (16, 16), 32, 64, 4, 2, 1,
     "leaky_relu"),
    ("dconv_forward", "disc_c3_B64", 64, (8, 8), 64, 128, 4, 2, 1,
     "leaky_relu"),
    ("dconv_forward", "cnn_l1_B64", 64, (32, 32), 3, 32, 3, 2, 1, "relu"),
    ("dconv_forward", "cnn_l2_B64", 64, (16, 16), 32, 64, 3, 2, 1, "relu"),
    ("dconv_forward", "cnn_l3_B64", 64, (8, 8), 64, 128, 3, 2, 1, "relu"),
]


def sweep_forwards(db, timer, emit, gen, dev) -> None:
    """Every tile and split of the forwards at FORWARD_LAYERS."""
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels.dconv_forward import dconv_forward_cuda
    from repro_torch.kernels.tconv_phase import tconv_fused_cuda

    for op, name, batch, hw, cin, cout, k, s, p, act in FORWARD_LAYERS:
        d = p if s == 1 else 1      # the ASPP branches: P = D = rate
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k,
                             dilation=d)
        ep = Epilogue(activation=act, slope=0.2)
        w = torch.randn((k, k, cin, cout), generator=gen).to(dev)
        if op == "tconv_phase":
            dy = torch.randn((batch, *hw, cout), generator=gen).to(dev)
            n_out = spec.input_size(hw)
            small = hw

            def run(plan=None):
                return tconv_fused_cuda(dy, w, spec, n_out=n_out,
                                        epilogue=ep, plan=plan)
        else:
            x = torch.randn((batch, *hw, cin), generator=gen).to(dev)
            n_out, small = None, spec.out_size(hw)

            def run(plan=None):
                return dconv_forward_cuda(x, w, spec, epilogue=ep, plan=plan)
        plans = db.candidates(op, spec, batch, small, cin, cout, n_out=n_out)
        want = run(plans[0])
        own_ms = min(timer(run) for _ in range(3))
        best = None
        for plan in plans[1:]:
            ok = torch.allclose(run(plan), want, atol=1e-4, rtol=1e-4)
            row = dict(layer=name, op=op, tile=db.TILES[plan.tile],
                       splits=plan.splits,
                       ms=min(timer(lambda: run(plan)) for _ in range(3)),
                       ok=ok)
            emit("sweep " + json.dumps(row))
            if best is None or row["ms"] < best["ms"]:
                best = row
        emit("best " + json.dumps(best | {
            "plan": [list(db.TILES[plans[0].tile]), plans[0].splits],
            "plan_ms": own_ms}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", choices=("all", "backward", "forward"),
                    default="all", help="which kernels to sweep")
    ap.add_argument("--layers", choices=("all", "main", "vision"),
                    default="all", help="which backward layers to sweep")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backward_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels import dconv_backward as db

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    timer = chip_smoke.DeviceTimer()
    gen = torch.Generator().manual_seed(0)
    lines = []

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    for kernel, name, batch, hw, cin, cout, k, s, p, act in (
            layer_rows(args.layers) if args.ops != "forward" else []):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k)
        ep = Epilogue(activation=act or "none", slope=0.2)
        oh_ow = spec.out_size(hw)
        w = torch.randn((k, k, cin, cout), generator=gen).to(dev)
        big = torch.randn((batch, *hw, cin), generator=gen).to(dev)
        small = torch.randn((batch, *oh_ow, cout), generator=gen).to(dev) \
            / (batch * oh_ow[0] * oh_ow[1]) ** 0.5
        out = torch.randn(small.shape if kernel == "conv_backward"
                          else big.shape, generator=gen).to(dev)
        out = None if act is None else torch.tanh(out) if act == "tanh" \
            else out
        if kernel == "conv_backward":
            def run(plan=None):
                return db.conv_backward_cuda(big, small, w, spec, n_out=hw,
                                             y=out, epilogue=ep, plan=plan)
        else:
            def run(plan=None):
                return db.tconv_backward_cuda(big, small, w, spec, z=out,
                                              epilogue=ep, plan=plan)
        plans = db.candidates(kernel, spec, batch, oh_ow, cin, cout,
                              n_out=hw)
        own = plans[0]
        want = run(own)
        own_ms = min(timer(run) for _ in range(3))
        best = None
        for plan in plans[1:]:
            got = run(plan)
            ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                     for a, b in zip(got, want) if b is not None)
            row = dict(layer=name, tile=db.TILES[plan.tile],
                       splits=plan.splits, dw_tile=db.TILES[plan.dw_tile],
                       dw_splits=plan.dw_splits,
                       ms=min(timer(lambda: run(plan)) for _ in range(3)),
                       ok=ok)
            emit("sweep " + json.dumps(row))
            if best is None or row["ms"] < best["ms"]:
                best = row
        emit("best " + json.dumps(best | {
            "plan": [list(db.TILES[own.tile]), own.splits,
                     list(db.TILES[own.dw_tile]), own.dw_splits],
            "plan_ms": own_ms}))
    if args.ops != "backward":
        sweep_forwards(db, timer, emit, gen, dev)
    card = chip_smoke.card_line()
    emit(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
