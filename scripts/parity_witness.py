#!/usr/bin/env python3
"""Which side of a family parity check is off: the card, or the CPU's
fp32 reference?

    python3 scripts/parity_witness.py [--arch zamba2-2.7b] [--layers 12]

Needs one CUDA card (the params are drawn there, as `chip_smoke.py`'s
phase 11 (a) draws them: `family_params` with FAMILY_SEED).  The same
prompts and forced tokens as `chip_smoke.py::family_parity` go through
a prefill and DECODES teacher-forced decodes in fp32, with the cache
made for `max_len` = the longest prompt + DECODES and + 2 * DECODES
(phase 11 (a)'s max_len with DECODES forced decodes, and with twice
as many): on the card, and on the CPU in fp32 and in fp64.  The fp64
run redirects every fp32 cast, `.float()` and fp32 factory call of the
model to fp64 (a TorchFunctionMode), so that no part of it rounds to
fp32, and its attention is the kernel's plain version
(`ops.flash_attention` takes fp32 and bf16 only).  Prints one JSON line
per call: the max |difference| of each pair
of runs' logits, and `ratio`s, the largest |difference| over
(atol + rtol |the second's logit|) at phase 11's PARITY_TOL (above 1
fails the check), then a summary line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DECODES = 4


class Fp64(TorchFunctionMode):
    """Every fp32 the model asks for, made fp64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.float:
            return args[0].double()
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        return func(*args, **kwargs)


def _plain64(q, k, v, causal=True, q_offset=None, blk_k=128,
             return_lse=False):
    from repro_torch.kernels.attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 blk_k=blk_k, return_lse=return_lse)


def run(lm, params, toks, forced, max_len, device, fp64=False) -> list:
    """Each call's logits (prefill, then the forced decodes) in fp64 on
    the CPU."""
    from repro_torch.kernels import ops
    out, logits = None, []
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        if fp64:
            stack.enter_context(Fp64())
            stack.enter_context(mock.patch.object(ops, "flash_attention",
                                                  _plain64))
        for step in range(len(forced) + 1):
            out = lm.prefill(params, torch.from_numpy(toks).to(device),
                             max_len) if step == 0 else \
                lm.decode_step(params, out[1], torch.from_numpy(
                    forced[step - 1].astype(np.int32)).to(device))
            logits.append(out[0].to("cpu", torch.float64))
    return logits


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import LM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parity_witness: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_config(args.arch).scaled(n_layers=args.layers,
                                       dtype="float32")
    lm = LM(cfg)
    dev_params = cs.family_params(cfg, cs.FAMILY_SEED)
    cpu_params = tree_map(lambda t: t.to("cpu"), dev_params)
    # family_parity's prompts and forced tokens (its first DECODES rows)
    rng = np.random.default_rng(13)
    lens = rng.integers(64, 201, cs.LM_BATCH)
    toks = np.zeros((cs.LM_BATCH, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        toks[i, toks.shape[1] - n:] = rng.integers(1, cfg.vocab, n)
    forced = rng.integers(1, cfg.vocab, (cs.PARITY_DECODES, cs.LM_BATCH,
                                         1))[:DECODES]
    short, long = toks.shape[1] + DECODES, toks.shape[1] + 2 * DECODES
    runs = {f"card_{short}": run(lm, dev_params, toks, forced, short,
                                 "cuda"),
            f"card_{long}": run(lm, dev_params, toks, forced, long, "cuda")}
    del dev_params
    torch.cuda.empty_cache()
    runs[f"cpu32_{short}"] = run(lm, cpu_params, toks, forced, short, "cpu")
    runs[f"cpu32_{long}"] = run(lm, cpu_params, toks, forced, long, "cpu")
    lm64 = LM(cfg.scaled(dtype="float64"))
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                   cpu_params)
    del cpu_params
    runs[f"cpu64_{long}"] = run(lm64, p64, toks, forced, long, "cpu",
                                fp64=True)
    ref = f"cpu64_{long}"
    pairs = [(f"card_{short}", f"card_{long}"),
             (f"cpu32_{short}", f"cpu32_{long}"),
             (f"card_{short}", f"cpu32_{short}"),
             (f"card_{long}", f"cpu32_{long}")] + \
        [(name, ref) for name in runs if name != ref]
    tol = cs.PARITY_TOL
    worst = {}
    for step in range(DECODES + 1):
        row = {"arch": args.arch, "n_layers": args.layers,
               "call": "prefill" if step == 0 else f"decode {step}"}
        for a, b in pairs:
            d = (runs[a][step] - runs[b][step]).abs()
            ratio = float((d / (tol + tol * runs[b][step].abs())).max())
            row[f"{a} - {b}"] = {"max_abs": float(d.max()), "ratio": ratio}
            worst[f"{a} - {b}"] = max(worst.get(f"{a} - {b}", 0.0), ratio)
        print("witness " + json.dumps(row), flush=True)
    print("witness summary " + json.dumps({
        "arch": args.arch, "n_layers": args.layers, "tol": tol,
        "max_len": [short, long], "worst_ratio": worst,
        "max_abs_logit": float(runs[ref][0].abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
