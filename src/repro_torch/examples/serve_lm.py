"""Batched serving example: continuous batching over prefill + decode
(counterpart of `examples/serve_lm.py`).

Loads a reduced (SMOKE) architecture on random params from seed 0,
enqueues more requests than the batch size and generates greedily:
slots are refilled as sequences finish.  On the card every attention of
every layer is one flash-attention kernel launch.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
          [--device cpu] [--arch qwen2-1.5b]

Without `--device` it runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Request, ServeEngine

MAX_LEN = 96


def make_requests(vocab: int, n: int, max_new: int) -> list:
    """`repro`'s request draw, bit for bit: prompts of 3-11 tokens in
    [1, vocab) from `np.random.default_rng(0)`."""
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(
                        1, vocab, int(rng.integers(3, 12)),
                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = LM(cfg).init(torch.Generator().manual_seed(0), device=dev)
    eng = ServeEngine(cfg, params, batch=args.batch, max_len=MAX_LEN,
                      device=dev)
    reqs = make_requests(cfg.vocab, args.requests, args.max_new)
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    for uid in sorted(results):
        print(f"req {uid:2d} ({len(reqs[uid].prompt)} prompt toks) "
              f"-> {results[uid]}")
    print(f"\n{len(reqs)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s) with batch={args.batch} "
          f"continuous batching on {dev}")
    assert len(results) == args.requests
    return results


if __name__ == "__main__":
    main()
