"""Multi-pod dry-run: trace every (architecture x input-shape x mesh) cell
as rank 0 of the production mesh and record its memory, FLOPs, kernel
launches and collectives (port of `repro/launch/dryrun.py`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--out dryrun_out]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary  # a table

This process becomes rank 0 of a fake world (`fake_world`: torch's
"fake" process-group backend, whose collectives complete and move
nothing) of 256 ranks (16 x 16) or 512 (2 x 16 x 16), and traces the
cell's step once (`launch/steps.py::lower_cell`, `Cell.trace`) on fake
tensors, which have shapes and no data: fake CPU tensors that stand for
the card's and take its path, with the attention kernels' fake forms in
place of their launches (`kernels/ops.py`), needing no card.  The
records feed `benchmarks/roofline.py`.

Each record (`{arch}.{shape}.{mesh}.json` in `--out`) keeps `repro`'s
keys where their meaning holds, all per rank: `argument_size_in_bytes`
(rank 0's blocks of params, optimizer state, inputs and cache),
`output_size_in_bytes`, `temp_size_in_bytes` (the trace's peak of live
bytes less the arguments), `alias_size_in_bytes` (arguments the step
writes in place and returns), `cost.flops` (`FlopCounterMode`'s count
plus the attention fake forms'), `collectives` (the five kinds with
`count` and result bytes, and `group_sizes`: the port issues all-gathers
and all-reduces only, so the other three stay 0), `lower_s` (building
the cell) and `compile_s` (the traced step).  `generated_code_size_in_
bytes` and `hlo_bytes` measure a compiled XLA executable, which the port
does not make, and are left out.  It adds `launches` and
`attention_forms` (the kernels' launches by form, as the card would make
them) and `peak_size_in_bytes` (arguments + temp).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch import configs
from repro_torch.benchmarks.roofline import RESULTS
from repro_torch.configs import ARCH_IDS, get_config, supported_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import lower_cell
from repro_torch.models.config import SHAPES


def fake_world(n: int) -> None:
    """Make this process rank 0 of a world of `n` ranks on torch's "fake"
    backend (a world of another size is ended first).  Its collectives
    return at once and leave their outputs as they were."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n,
                            store=dist.HashStore())


def cells(arch=None, shape=None, multi_pod=False, all_cells=False) -> list:
    """(arch, shape, multi_pod) of one cell, or of `--all`: every arch's
    supported shapes on both meshes."""
    if not all_cells:
        return [(arch, shape, multi_pod)]
    return [(a, s, mp) for a in ARCH_IDS
            for s in supported_shapes(get_config(a)) for mp in (False, True)]


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
             serve_sharding: str = "train", n_micro=None, remat=None,
             bf16_params: bool = False, moe_ffn_data: bool = False,
             kv_quant: bool = False, tag: str = "") -> dict:
    cfg = get_config(arch)
    if kv_quant:
        cfg = cfg.scaled(kv_quant=True)
    shape = SHAPES[shape_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    cell = lower_cell(cfg, shape, mesh, serve_sharding=serve_sharding,
                      n_micro=n_micro, remat=remat, bf16_params=bf16_params,
                      moe_ffn_data=moe_ffn_data)
    t1 = time.time()
    traced = cell.trace()
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": 512 if multi_pod else 256,
        "lower_s": round(t1 - t0, 1),
        "compile_s": round(traced.pop("compile_s"), 1),
        "variant": {"serve_sharding": serve_sharding, "n_micro": n_micro,
                    "remat": remat},
        "effective_n_micro": cell.n_micro,
        **traced,
    }
    rec["peak_size_in_bytes"] = rec["argument_size_in_bytes"] + \
        rec["temp_size_in_bytes"]
    if tag:
        shape_name = f"{shape_name}.{tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}.{shape_name}.{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


CARD_BYTES = 80e9        # an H100's 80 GB of HBM3


def summary(out_dir: str) -> list:
    """One markdown row per record in `out_dir`: the cell, rank 0's peak
    (arguments + temp) in GB, whether it fits the card, FLOPs a rank,
    the collectives' count and GB, the attention launches and the trace's
    seconds."""
    rows = []
    for arch, s, mp in cells(all_cells=True):
        mesh = "2x16x16" if mp else "16x16"
        path = os.path.join(out_dir, f"{arch}.{s}.{mesh}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            r = json.load(f)
        coll = [v for k, v in r["collectives"].items() if k != "group_sizes"]
        fits = "yes" if r["peak_size_in_bytes"] <= CARD_BYTES else "no"
        rows.append(
            f"| {arch} | {s} | {mesh} | {r['peak_size_in_bytes'] / 1e9:.2f} "
            f"| {fits} | {r['cost']['flops']:.3e} "
            f"| {sum(c['count'] for c in coll)} "
            f"| {sum(c['bytes'] for c in coll) / 1e9:.2f} "
            f"| {sum(r['launches'].values())} | {r['compile_s']} |")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(
        set(ARCH_IDS) | {a.replace("_", "-") for a in ARCH_IDS}
        | set(configs._ALIASES)))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port traces torch ops, no HLO")
    ap.add_argument("--serve-sharding", choices=("train", "tp"),
                    default="train",
                    help="'tp' = serve-time resharded weights")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--remat", choices=("none", "full"), default=None)
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 storage params + fp32 master in opt state")
    ap.add_argument("--moe-ffn-shard", action="store_true",
                    help="shard expert FFN dim (not D) over the data axis")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--tag", default="",
                    help="suffix for the output artifact filename")
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the records in --out and exit "
                         "(fits: a peak within the card's 80 GB)")
    args = ap.parse_args()
    if args.summary:
        print("| arch | shape | mesh | peak GB | fits | FLOPs | "
              "collectives | coll. GB | launches | trace s |")
        print("| --- " * 10 + "|")
        print("\n".join(summary(args.out)))
        return
    if args.save_hlo:
        ap.error("--save-hlo: the port traces torch ops and makes no HLO")
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")

    failures = 0
    for arch, s, mp in cells(args.arch, args.shape, args.multi_pod,
                             args.all):
        tag = f"{arch} x {s} x {'2x16x16' if mp else '16x16'}"
        try:
            rec = run_cell(arch, s, mp, args.out,
                           serve_sharding=args.serve_sharding,
                           n_micro=args.n_micro, remat=args.remat,
                           bf16_params=args.bf16_params,
                           moe_ffn_data=args.moe_ffn_shard,
                           kv_quant=args.kv_quant, tag=args.tag)
            print(f"OK   {tag}: trace={rec['compile_s']}s "
                  f"flops={rec['cost']['flops']:.3e} "
                  f"peak={rec['peak_size_in_bytes'] / 1e9:.2f}GB "
                  f"temp={rec['temp_size_in_bytes'] / 1e9:.2f}GB",
                  flush=True)
        except Exception:
            failures += 1
            print(f"FAIL {tag}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
