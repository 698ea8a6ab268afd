#!/usr/bin/env python3
"""Device time of the conv kernels on the tiled implicit-GEMM engine at
the main-path layers, for each tile and split count the kernels take: the
sweep that `kernels/dconv_backward.py::plan`'s constants come from.

    python3 scripts/backward_plan_sweep.py [--ops all|backward|forward]
                                           [--out FILE]

Needs one CUDA card and `nvcc`.  The backwards, at the nine layers of
conv training (batch 64): per layer it holds the dx / ddy tile at the one
the plan takes for that N (256 x 4 at N <= 4, else 128 x 32), tries the
dW tiles 64 x 32 and (at Cout > 32) 64 x 64, and every split count of
{1, 2, 4, 8, 16} (dx / ddy) x {4, 8, 16, 32, 64} (dW).  The forwards
(`tconv_phase`, `dconv_forward`), at the generator's t1 and t2 and the
ASPP branches at the serving slot batch 4 and at t1, t2, discriminator
c1-c3 and CNN l1-l3 at batch 64: the tiles 128 x 32 and 256 x 16 and
every split count of {1, 2, 4, 8, 16} that leaves no split empty.  Each
launch is checked against the plan's own within 1e-4 and timed with CUDA
events (the least of three `chip_smoke.DeviceTimer` readings of 20
launches).  One JSON line per configuration, one `best` line per layer
(with the plan's own time and configuration), then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from backward_roles import BATCH, LAYERS  # noqa: E402

SPLITS = (1, 2, 4, 8, 16)
DW_SPLITS = (4, 8, 16, 32, 64)
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


def forced_plan(db, planner, op, spec, batch, big_hw, small_hw, cin, cout,
                n_out, bias, tile, splits, dw_tile, dw_splits):
    """The BackwardPlan of these tiles and splits, counted as `planner`
    (the plan itself) counts them."""
    base = planner(op, spec, batch, big_hw, small_hw, cin, cout,
                   n_out=n_out, bias=bias)
    kh, kw = spec.filter_shape
    bm, bn = db.TILES[tile]
    n = cin if op == "conv_backward" else cout
    if op == "conv_backward":
        rows = [batch * hc * wc for hc, wc, _ in db.phase_classes(spec, n_out)]
    else:
        rows = [batch * small_hw[0] * small_hw[1]]
    tiles = sum(-(-r // bm) for r in rows) * -(-n // bn)
    dbm, dbn = db.TILES[dw_tile]
    dw_tiles = -(-kh * kw * cin // dbm) * -(-cout // dbn)
    positions = batch * small_hw[0] * small_hw[1]
    ws = (dw_tiles * dbm * dbn + base.db_tiles * db.CHANNEL_TILE) \
        * dw_splits if dw_splits > 1 else 0
    ws += tiles * splits * bm * bn if splits > 1 else 0
    return db.BackwardPlan(tile, splits, dw_tile, dw_splits,
                           db.split_chunk(positions, dw_splits), tiles,
                           dw_tiles, base.db_tiles, ws)


def forced_forward_plan(db, op, spec, batch, big_hw, small_hw, cin, cout,
                        n_out, tile, splits):
    """The forward BackwardPlan of this tile and split count, counted as
    the plan counts its tiles."""
    bm, bn = db.TILES[tile]
    if op == "tconv_phase":
        rows, n = [batch * hc * wc for hc, wc, _ in
                   db.phase_classes(spec, n_out)], cin
    else:
        rows, n = [batch * small_hw[0] * small_hw[1]], cout
    tiles = sum(-(-r // bm) for r in rows) * -(-n // bn)
    return db.BackwardPlan(tile, splits, -1, 1, 0, tiles, 0, 0,
                           tiles * splits * bm * bn if splits > 1 else 0)


def sweep_forwards(db, ops, timer, emit, gen, dev) -> None:
    """Every tile and split of the forwards at FORWARD_LAYERS."""
    from repro_torch.core.spec import ConvSpec, Epilogue

    planner = db.plan
    for op, name, batch, hw, cin, cout, k, s, p, act in FORWARD_LAYERS:
        d = p if s == 1 else 1      # the ASPP branches: P = D = rate
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k,
                             dilation=d)
        ep = Epilogue(activation=act, slope=0.2)
        w = torch.randn((k, k, cin, cout), generator=gen).to(dev)
        if op == "tconv_phase":
            dy = torch.randn((batch, *hw, cout), generator=gen).to(dev)
            n_out = spec.input_size(hw)
            big, small, n, red = n_out, hw, cin, max(
                t for _, _, t in db.phase_classes(spec, n_out)) * cout

            def run():
                return ops.tconv_phase(dy, w, stride=s, padding=p,
                                       n_out=n_out, dilation=d,
                                       epilogue=ep, strategy="phase")
        else:
            x = torch.randn((batch, *hw, cin), generator=gen).to(dev)
            n_out, big, small = None, hw, spec.out_size(hw)
            n, red = cout, k * k * cin

            def run():
                return ops.dconv_forward(x, w, stride=s, padding=p,
                                         dilation=d, epilogue=ep)
        want = run()
        own = planner(op, spec, batch, big, small, cin, cout, n_out=n_out)
        own_ms = min(timer(run) for _ in range(3))
        tiles = (db.THIN,) if n <= 4 else (db.TALL, db.HALF)
        best = None
        try:
            for tile, splits in itertools.product(tiles, SPLITS):
                if splits > 1 and (splits - 1) * db.split_chunk(
                        red, splits) >= red:
                    continue                        # a split left empty
                db.plan = lambda op_, sp, b, bh, sh, ci, co, n_out=None, \
                    bias=False, tile=tile, splits=splits: \
                    forced_forward_plan(db, op_, sp, b, bh, sh, ci, co,
                                        n_out, tile, splits)
                ok = torch.allclose(run(), want, atol=1e-4, rtol=1e-4)
                row = dict(layer=name, op=op, tile=db.TILES[tile],
                           splits=splits,
                           ms=min(timer(run) for _ in range(3)), ok=ok)
                emit("sweep " + json.dumps(row))
                if best is None or row["ms"] < best["ms"]:
                    best = row
        finally:
            db.plan = planner
        emit("best " + json.dumps(best | {
            "plan": [list(db.TILES[own.tile]), own.splits],
            "plan_ms": own_ms}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", choices=("all", "backward", "forward"),
                    default="all", help="which kernels to sweep")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backward_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels import dconv_backward as db
    from repro_torch.kernels import ops

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    timer = chip_smoke.DeviceTimer()
    gen = torch.Generator().manual_seed(0)
    planner = db.plan
    lines = []

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    for kernel, name, hw, cin, cout, k, act in (
            LAYERS if args.ops != "forward" else []):
        spec = ConvSpec.make(stride=2, padding=1, filter_shape=k)
        ep = Epilogue(activation=act, slope=0.2)
        oh_ow = spec.out_size(hw)
        w = torch.randn((k, k, cin, cout), generator=gen).to(dev)
        big = torch.randn((BATCH, *hw, cin), generator=gen).to(dev)
        small = torch.randn((BATCH, *oh_ow, cout), generator=gen).to(dev) \
            / (BATCH * oh_ow[0] * oh_ow[1]) ** 0.5
        out = torch.randn(small.shape if kernel == "conv_backward"
                          else big.shape, generator=gen).to(dev)
        out = torch.tanh(out) if act == "tanh" else out
        if kernel == "conv_backward":
            def run():
                return ops.conv_backward(big, small, w, stride=2, padding=1,
                                         n_out=hw, y=out, epilogue=ep)
            n = cin
        else:
            def run():
                return ops.tconv_backward(big, small, w, stride=2, padding=1,
                                          z=out, epilogue=ep)
            n = cout
        want = run()
        own = planner(kernel, spec, BATCH, hw, oh_ow, cin, cout, n_out=hw)
        own_ms = min(timer(run) for _ in range(3))
        tile = db.THIN if n <= 4 else db.TALL
        dw_tiles = (db.SMALL,) if cout <= 32 else (db.SQUARE, db.SMALL)
        best = None
        try:
            for dw_tile, s, ds in itertools.product(dw_tiles, SPLITS,
                                                    DW_SPLITS):
                db.plan = lambda op, sp, b, bh, sh, ci, co, n_out=None, \
                    bias=False, dw_tile=dw_tile, s=s, ds=ds: forced_plan(
                        db, planner, op, sp, b, bh, sh, ci, co, n_out, bias,
                        tile, s, dw_tile, ds)
                got = run()
                ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                         for a, b in zip(got, want) if b is not None)
                row = dict(layer=name, tile=db.TILES[tile], splits=s,
                           dw_tile=db.TILES[dw_tile], dw_splits=ds,
                           ms=min(timer(run) for _ in range(3)), ok=ok)
                emit("sweep " + json.dumps(row))
                if best is None or row["ms"] < best["ms"]:
                    best = row
        finally:
            db.plan = planner
        emit("best " + json.dumps(best | {
            "plan": [list(db.TILES[own.tile]), own.splits,
                     list(db.TILES[own.dw_tile]), own.dw_splits],
            "plan_ms": own_ms}))
    if args.ops != "backward":
        sweep_forwards(db, ops, timer, emit, gen, dev)
    card = chip_smoke.card_line()
    emit(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
