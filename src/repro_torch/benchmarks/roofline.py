"""Roofline analysis per (arch x shape) cell on the single-pod 16x16 mesh
(port of `benchmarks/roofline.py`).

Three terms (seconds per step), each on one device of `Hardware` (the
H100 SXM unless the caller passes another):

  compute    = FLOPs            / (chips * hw.peak_flops)
  memory     = HBM bytes        / (chips * hw.hbm_bw)
  collective = collective bytes / (chips * hw.link_bw)

The terms come from the analytic per-step model in
`benchmarks/flops.py`.  Where the dry-run (`launch/dryrun.py`) has
written the cell's record into RESULTS, the row also carries what the
trace of rank 0's step counted, under `repro`'s keys: `hlo_flops` (the
trace's FLOPs, one rank's), `hlo_temp_gib` (its peak less its
arguments), `hlo_coll_counts` (its collectives by kind) and `compile_s`
(the trace's seconds).

Output: RESULTS/roofline.csv + stdout rows.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.roofline
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.benchmarks import flops as F
from repro_torch.configs import ARCH_IDS, get_config, supported_shapes
from repro_torch.models.config import SHAPES

CHIPS = 256          # single-pod 16x16: the roofline is of one pod
# The dry-run's records (gitignored): dryrun_out/ at the repository root.
RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "dryrun_out")


def _load(arch: str, shape: str, mesh: str = "16x16") -> Optional[dict]:
    p = os.path.join(RESULTS, f"{arch}.{shape}.{mesh}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def cell_roofline(arch: str, shape_name: str,
                  hw: F.Hardware = F.H100_SXM) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cc = F.cell_cost(cfg, shape)

    compute_s = cc.impl_flops / (CHIPS * hw.peak_flops)
    memory_s = cc.hbm_bytes / (CHIPS * hw.hbm_bw)
    coll_s = (cc.coll_bytes_tp + cc.coll_bytes_dp) / (CHIPS * hw.link_bw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # roofline fraction: useful compute time / bound time (how close the
    # step is to the pure-compute roofline of its useful FLOPs)
    ideal_s = cc.model_flops / (CHIPS * hw.peak_flops)
    rec = {
        "arch": arch, "shape": shape_name, "chips": CHIPS,
        "model_flops": cc.model_flops, "impl_flops": cc.impl_flops,
        "useful_ratio": cc.model_flops / cc.impl_flops,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "step_bound_s": bound,
        "roofline_frac": ideal_s / bound,
        "notes": cc.notes,
    }
    dj = _load(arch, shape_name)
    if dj:
        rec["hlo_flops"] = dj.get("cost", {}).get("flops", 0.0)
        rec["hlo_temp_gib"] = dj.get("temp_size_in_bytes", 0) / 2**30
        cols = dj.get("collectives", {})
        rec["hlo_coll_counts"] = {
            k: v["count"] for k, v in cols.items()
            if isinstance(v, dict) and v.get("count")}
        rec["compile_s"] = dj.get("compile_s")
    return rec


def all_cells(hw: F.Hardware = F.H100_SXM):
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in supported_shapes(cfg):
            rows.append(cell_roofline(arch, s, hw))
    return rows


def bench_rows(hw: F.Hardware = F.H100_SXM):
    """name,value,derived rows."""
    out = []
    for r in all_cells(hw):
        out.append((
            f"roofline.{r['arch']}.{r['shape']}",
            round(r["roofline_frac"], 4),
            f"dom={r['dominant']};compute_s={r['compute_s']:.4f};"
            f"memory_s={r['memory_s']:.4f};coll_s={r['collective_s']:.4f};"
            f"useful={r['useful_ratio']:.2f}"))
    return out


def write_csv(path=None, hw: F.Hardware = F.H100_SXM):
    rows = all_cells(hw)
    path = path or os.path.join(RESULTS, "roofline.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cols = ["arch", "shape", "dominant", "roofline_frac", "useful_ratio",
            "compute_s", "memory_s", "collective_s", "step_bound_s",
            "model_flops", "impl_flops", "hlo_flops", "hlo_temp_gib",
            "compile_s", "notes"]
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
    return path, rows


def main():
    path, rows = write_csv()
    print(f"# wrote {path} ({F.H100_SXM.name})")
    hdr = f"{'arch':24s} {'shape':12s} {'dom':10s} {'roofline':>8s} " \
          f"{'useful':>6s} {'comp_s':>8s} {'mem_s':>8s} {'coll_s':>8s}"
    print(hdr)
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} {r['dominant']:10s} "
              f"{r['roofline_frac']:8.3f} {r['useful_ratio']:6.2f} "
              f"{r['compute_s']:8.4f} {r['memory_s']:8.4f} "
              f"{r['collective_s']:8.4f}")


if __name__ == "__main__":
    main()
