#!/usr/bin/env python3
"""zamba2-2.7b's attention at head_dim 80: each kernel form at its
shapes, and the model's served prefill and training step against another
tree's (a parent commit's).

    python3 scripts/zamba2_attention.py [--parent DIR]

Needs one CUDA card and `nvcc`.  (1) The forward and the backward in
bf16 at zamba2's shared block (32 heads, head_dim 80, causal) at the
engine's batch 4 x S 1024 and the training microbatch of 2 x S 4096: on
the forms the plans pick, on the SIMT forms forced (`tile`, `simt`), and
SDPA (its backward: forward + backward less the forward), each form held
against the plain version at one bf16 ulp (atol 1e-4, rtol 2^-7) and
timed with CUDA events (`chip_smoke.DeviceTimer`); the bound is
`chip_smoke.bound_ms` of 4 D (forward) or 10 D (backward) operations a
visible pair and the operands' bytes.  (2) With `--parent` (the root of
another tree, e.g. `git archive <commit> | tar -x -C build/parent`):
`chip_smoke.family_serve` and `family_train` for zamba2-2.7b from each
tree's own `chip_smoke.py`, in fresh processes in the order parent,
this, this, parent, each building its tree's kernels; their `family
serve` and `family_train` lines are kept.  One JSON line per case and
per run, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

HEADS, D = 32, 80
SHAPES = [(4, 1024), (2, 4096)]          # (B, S)
TOL = (1e-4, 2.0 ** -7)                  # (atol, rtol): one bf16 ulp
RUN = """
import json, sys
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
card = c.card_line()
c.family_serve(card, "zamba2-2.7b")
c.family_train(card, "zamba2-2.7b", *c.FAMILY_TRAIN["zamba2-2.7b"])
"""


def forms(timer) -> bool:
    """Part (1); True if every form agrees with its plain version."""
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels.attention import (
        AttentionPlan, backward_plan, flash_attention_backward_cuda,
        flash_attention_backward_plain, flash_attention_cuda,
        flash_attention_plain, plan, visible_pairs)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, S in SHAPES:
        q, k, v, do = (torch.randn((B, S, HEADS, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        pairs = B * HEADS * visible_pairs(S, S, True, 0)
        fwd_plain = flash_attention_plain(q, k, v)
        out, lse = flash_attention_cuda(
            q, k, v, causal=True, q_offset=0, form=plan(
                torch.bfloat16, B, S, S, HEADS, HEADS, D), return_lse=True)
        bwd_plain = flash_attention_backward_plain(q, k, v, out, do, lse)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(backward):
            a, b, c = (t.detach().requires_grad_(backward)
                       for t in (qt, kt, vt))
            o = F.scaled_dot_product_attention(a, b, c, is_causal=True)
            if backward:
                torch.autograd.grad(o, (a, b, c), do.transpose(1, 2))

        iters = 5 if S >= 4096 else 20
        sdpa_fwd = timer(lambda: sdpa(False), iters)
        sdpa_bwd = timer(lambda: sdpa(True), iters) - sdpa_fwd
        for kind, chosen, old in (
                ("forward", plan(torch.bfloat16, B, S, S, HEADS, HEADS,
                                 D).form, "tile"),
                ("backward", backward_plan(torch.bfloat16, B, S, S, HEADS,
                                           HEADS, D), "simt")):
            for form in (chosen, old):
                if kind == "forward":
                    def run(f=form):
                        return flash_attention_cuda(
                            q, k, v, causal=True, q_offset=0,
                            form=AttentionPlan(f, 1))
                    want, macs, lib = (fwd_plain,), 2 * D * pairs, sdpa_fwd
                    nbytes = 2 * 4 * q.numel()
                else:
                    def run(f=form):
                        return flash_attention_backward_cuda(
                            q, k, v, out, do, lse, causal=True, q_offset=0,
                            form=f)
                    want, macs, lib = bwd_plain, 5 * D * pairs, sdpa_bwd
                    nbytes = 2 * 8 * q.numel() + 4 * lse.numel()
                got = run()
                got = got if isinstance(got, tuple) else (got,)
                agree = all(torch.allclose(a.float(), b.float(), atol=TOL[0],
                                           rtol=TOL[1])
                            for a, b in zip(got, want))
                rerun = run()
                rerun = rerun if isinstance(rerun, tuple) else (rerun,)
                bit_equal = all(torch.equal(a, b) for a, b in zip(got, rerun))
                ok &= agree and bit_equal
                bound, by = chip_smoke.bound_ms(nbytes, macs,
                                                chip_smoke.BF16_FLOPS_PER_S)
                print("case " + json.dumps({
                    "kind": kind, "B": B, "S": S, "heads": HEADS, "D": D,
                    "form": form, "planned": form == chosen,
                    "ms": timer(run, iters), "sdpa_ms": lib,
                    "bound_ms": bound, "bound_by": by,
                    "max_abs_err": max((a.float() - b.float()).abs().max()
                                       .item() for a, b in zip(got, want)),
                    "agrees": agree, "rerun_bit_equal": bit_equal}))
        del q, k, v, do, out, lse, fwd_plain, bwd_plain
        torch.cuda.empty_cache()
    return ok


def tree_runs(parent: Path) -> bool:
    """Part (2); True if every run exited 0."""
    ok = True
    for tag, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                      ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=str(tree / "src") + os.pathsep
                   + str(tree))
        done = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                              capture_output=True, text=True)
        ok &= done.returncode == 0
        rows = [line for line in done.stdout.splitlines()
                if line.startswith(("family serve ", "family train "))]
        for line in rows:
            kind, row = line[:12], json.loads(line[13:])
            print("run " + json.dumps({"tree": tag, "kind": kind} | row))
        if done.returncode:
            print(f"run {tag} failed:\n{done.stdout[-3000:]}"
                  f"{done.stderr[-3000:]}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path,
                    help="the root of another tree to run part (2) against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = forms(chip_smoke.DeviceTimer())
    if args.parent is not None:
        ok &= tree_runs(args.parent.resolve())
    print(json.dumps({"card": chip_smoke.card_line(), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
