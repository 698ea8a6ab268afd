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

Then, to locate the ops that carry the difference, layer by layer:
  * `witness layer` lines: the output of every Mamba2 and attention
    block of the three max_len + 2 * DECODES runs (the card, the CPU's
    fp32, fp64), each call's blocks in order, the card's and the CPU's
    fp32 distance from fp64 (max |diff| over the fp64 output's max);
  * `witness op` lines: each op of the fp64 run -- the SSM scan
    (`chunked_linear_attention`, `linear_attention_decode`), the
    attention kernel (`ops.flash_attention`), the Mamba2 in_proj matmul
    (`_mamba_parts`) and its gated norm + out_proj matmul (`_mamba_out`),
    the attention blocks (q/k/v/o matmuls, rope, attention) and the
    logits head -- replayed in fp32 on its recorded fp64 inputs (cast to
    fp32) on the card and on the CPU: each side's error from the fp64
    output, summed over calls, so an op's own rounding is seen apart from
    the drift it receives.  The per-call rows go to `--ops-out`
    (default build/parity_witness_ops.jsonl);
  * a `witness matmul` line: the first prefill's in_proj product
    x @ in_proj (M = batch x prompt rows, K = d_model) in fp32 on the
    card, on the card with K cut into SPLIT_K partial products summed in
    fp32, and on the CPU, each against fp64: whether the card's error is
    its matmul's sum order.
TF32 is off for cuDNN and matmuls, as in `chip_smoke.py`.
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
SPLIT_K = 16


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


def _ops():
    """The recorded ops: name -> (module, attribute)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    return {"ssm_scan": (S, "chunked_linear_attention"),
            "ssm_step": (S, "linear_attention_decode"),
            "attention": (ops, "flash_attention"),
            "in_proj": (S, "_mamba_parts"),
            "mamba_out": (S, "_mamba_out"),
            "mamba_prefill": (S, "mamba2_prefill"),
            "mamba_decode": (S, "mamba2_decode"),
            "attn_block": (L, "attention_block"),
            "attn_decode": (L, "attention_decode"),
            "logits_head": (L, "logits_head")}


BLOCKS = ("mamba_prefill", "mamba_decode", "attn_block", "attn_decode")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _snap(obj, keep):
    """`obj` with every tensor cloned, but views of the params (whose
    storages are `keep`): a call's inputs as it saw them (a decode writes
    its cache in place)."""
    if isinstance(obj, torch.Tensor):
        return obj if _storage(obj) in keep else obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_snap(o, keep) for o in obj)
    if isinstance(obj, dict):
        return {k: _snap(v, keep) for k, v in obj.items()}
    return obj


class Recorder:
    """Patches every op of `_ops()` to record, per call, its step, its
    outputs (fp64 on the CPU) and, with `inputs`, a snapshot of its
    arguments (the params' views, whose storages are `keep`, by
    reference).  The ops run as patched in the caller (the fp64 run's
    attention is `_plain64`)."""

    def __init__(self, inputs=False, keep=()):
        self.inputs, self.keep = inputs, keep
        self.rows, self.step = [], None

    @contextlib.contextmanager
    def active(self):
        with contextlib.ExitStack() as stack:
            for name, (mod, attr) in _ops().items():
                stack.enter_context(mock.patch.object(
                    mod, attr, self._wrap(name, getattr(mod, attr))))
            yield self

    def _wrap(self, name, fn):
        def op(*args, **kwargs):
            snap = _snap((args, kwargs), self.keep) if self.inputs else None
            out = fn(*args, **kwargs)
            self.rows.append({
                "name": name, "step": self.step, "inputs": snap,
                "outputs": [t.detach().to("cpu", torch.float64, copy=True)
                            for t in _tensors(out)
                            if t.is_floating_point()]})
            return out
        return op


def run(lm, params, toks, forced, max_len, device, fp64=False,
        recorder=None) -> list:
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
        if recorder is not None:
            stack.enter_context(recorder.active())
        for step in range(len(forced) + 1):
            if recorder is not None:
                recorder.step = "prefill" if step == 0 else f"decode {step}"
            out = lm.prefill(params, torch.from_numpy(toks).to(device),
                             max_len) if step == 0 else \
                lm.decode_step(params, out[1], torch.from_numpy(
                    forced[step - 1].astype(np.int32)).to(device))
            logits.append(out[0].to("cpu", torch.float64))
    return logits


def _rel(got, want) -> float:
    """max |got - want| over max |want| (the worst output of a call)."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g.to("cpu", torch.float64) - w).abs()
                                 .max()) / scale)
    return worst


def layer_rows(card, cpu32, cpu64) -> list:
    """Each block call of the three runs, in order: the card's and the
    CPU's fp32 distance from fp64."""
    rows, seen = [], {}
    trio = [[r for r in rec.rows if r["name"] in BLOCKS]
            for rec in (card, cpu32, cpu64)]
    assert len({len(t) for t in trio}) == 1, [len(t) for t in trio]
    for a, b, c in zip(*trio):
        assert a["name"] == b["name"] == c["name"]
        key = (c["step"], c["name"])
        seen[key] = seen.get(key, -1) + 1
        rows.append({"step": c["step"], "block": c["name"],
                     "index": seen[key],
                     "card": _rel(a["outputs"][:1], c["outputs"][:1]),
                     "cpu32": _rel(b["outputs"][:1], c["outputs"][:1])})
    return rows


def replay(rec, cfg32, card) -> list:
    """Each op call of the fp64 run `rec`, run again in fp32 on its
    recorded inputs, on the card and on the CPU (the real ops, unpatched):
    each side's distance from the fp64 output."""
    from repro_torch.models.config import ModelConfig
    fns = {name: getattr(mod, attr) for name, (mod, attr) in _ops().items()}
    cache = {}

    def cast(obj, dev):
        if isinstance(obj, torch.Tensor):
            if _storage(obj) in rec.keep:     # a param: cast once
                key = (obj.data_ptr(), tuple(obj.shape), obj.stride(), dev)
                if key not in cache:
                    cache[key] = obj.to(dev, torch.float32)
                return cache[key]
            return obj.to(dev, torch.float32) if obj.is_floating_point() \
                else obj.to(dev)
        if isinstance(obj, ModelConfig):
            return cfg32
        if isinstance(obj, (tuple, list)):
            return type(obj)(cast(o, dev) for o in obj)
        if isinstance(obj, dict):
            return {k: cast(v, dev) for k, v in obj.items()}
        return obj

    rows = []
    with torch.no_grad():
        for r in rec.rows:
            row = {"name": r["name"], "step": r["step"]}
            for side, dev in (("card", card), ("cpu32", "cpu")):
                args, kwargs = cast(r["inputs"], dev)
                out = [t for t in _tensors(fns[r["name"]](*args, **kwargs))
                       if t.is_floating_point()]
                row[side] = _rel(out, r["outputs"])
            rows.append(row)
    return rows


def matmul_probe(rec) -> dict:
    """x @ in_proj of the fp64 run's first prefill in_proj call, in fp32:
    cuBLAS on the card, the same with K in SPLIT_K chunks, the CPU; each
    as max |diff| over max |fp64 product|."""
    r = next(r for r in rec.rows
             if r["name"] == "in_proj" and r["step"] == "prefill")
    params, x = r["inputs"][0][:2]
    w = params["in_proj"]
    want = x @ w
    scale = float(want.abs().max())
    x32, w32 = x.float(), w.float()
    xc, wc = x32.cuda(), w32.cuda()
    split = sum(a @ b for a, b in zip(xc.chunk(SPLIT_K, -1),
                                      wc.chunk(SPLIT_K, 0)))

    def err(t):
        return float((t.to("cpu", torch.float64) - want).abs().max()) / scale

    return {"m": int(x.numel() // x.shape[-1]), "k": int(w.shape[0]),
            "n": int(w.shape[1]), "card_cublas": err(xc @ wc),
            f"card_split_k{SPLIT_K}": err(split), "cpu32": err(x32 @ w32)}


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import LM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--ops-out", type=Path,
                    default=ROOT / "build" / "parity_witness_ops.jsonl",
                    help="where the per-call op rows are written (JSONL)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parity_witness: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    recs = {"card": Recorder(), "cpu32": Recorder()}
    runs = {f"card_{short}": run(lm, dev_params, toks, forced, short,
                                 "cuda"),
            f"card_{long}": run(lm, dev_params, toks, forced, long, "cuda",
                                recorder=recs["card"])}
    del dev_params
    torch.cuda.empty_cache()
    runs[f"cpu32_{short}"] = run(lm, cpu_params, toks, forced, short, "cpu")
    runs[f"cpu32_{long}"] = run(lm, cpu_params, toks, forced, long, "cpu",
                                recorder=recs["cpu32"])
    lm64 = LM(cfg.scaled(dtype="float64"))
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                   cpu_params)
    del cpu_params
    from repro_torch.models.layers import tree_leaves
    recs["cpu64"] = Recorder(inputs=True,
                             keep={_storage(t) for t in tree_leaves(p64)})
    runs[f"cpu64_{long}"] = run(lm64, p64, toks, forced, long, "cpu",
                                fp64=True, recorder=recs["cpu64"])
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
        "max_abs_logit": float(runs[ref][0].abs().max())}), flush=True)

    # -- layer by layer, then each op on the fp64 run's inputs ------------
    for row in layer_rows(recs["card"], recs["cpu32"], recs["cpu64"]):
        print("witness layer " + json.dumps(row), flush=True)
    del recs["card"], recs["cpu32"]
    print("witness matmul " + json.dumps(matmul_probe(recs["cpu64"])
                                         | {"device": card_name()}),
          flush=True)
    op_rows = replay(recs["cpu64"], cfg, "cuda")
    args.ops_out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.ops_out, "w") as f:
        for row in op_rows:
            f.write(json.dumps(row) + "\n")
    summary = {}
    for row in op_rows:
        s = summary.setdefault((row["name"], row["step"] == "prefill"), {
            "calls": 0, "card_max": 0.0, "cpu32_max": 0.0,
            "card_sum": 0.0, "cpu32_sum": 0.0})
        s["calls"] += 1
        for side in ("card", "cpu32"):
            s[f"{side}_max"] = max(s[f"{side}_max"], row[side])
            s[f"{side}_sum"] += row[side]
    for (name, prefill), s in summary.items():
        print("witness op " + json.dumps({
            "op": name, "call": "prefill" if prefill else "decode",
            "calls": s["calls"], "card_max": s["card_max"],
            "cpu32_max": s["cpu32_max"],
            "card_mean": s["card_sum"] / s["calls"],
            "cpu32_mean": s["cpu32_sum"] / s["calls"],
            "card_over_cpu32": s["card_sum"] / max(s["cpu32_sum"], 1e-300),
            "card": card_name()}), flush=True)
    return 0


def card_name() -> str:
    import chip_smoke as cs
    return cs.card_line()


if __name__ == "__main__":
    sys.exit(main())
