#!/usr/bin/env python3
"""Device time of the fused conv backwards at the nine main-path layers of
conv training, for each tile and split count the kernels take: the sweep
that `kernels/dconv_backward.py::plan`'s constants come from.

    python3 scripts/backward_plan_sweep.py [--out FILE]

Needs one CUDA card and `nvcc`.  Per layer it holds the dx / ddy tile at
the one the plan takes for that N (256 x 4 at N <= 4, else 128 x 32),
tries the dW tiles 64 x 32 and (at Cout > 32) 64 x 64, and every split
count of {1, 2, 4, 8, 16} (dx / ddy) x {4, 8, 16, 32, 64} (dW); each
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    for kernel, name, hw, cin, cout, k, act in LAYERS:
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
    card = chip_smoke.card_line()
    emit(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
