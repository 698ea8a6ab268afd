"""Serving launcher (port of `repro/launch/serve.py`): batched greedy
generation with the continuous-batching engine, on random params from
seed 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu

Without `--device` it runs on the card (and fails without one).  The
request stream is `repro`'s: prompts of 3-8 tokens drawn from
`np.random.default_rng(0)`.

`--mesh DxM` serves on a ("data", "model") mesh of D*M `gloo` ranks
(`launch/mesh.py::run_ranks`), every rank drawing the same params and
laying them out by `--serve-sharding` (train: the training layout; tp:
the data axes folded into tensor parallelism, the weights resident);
rank 0 prints the tokens:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --mesh 2x2 --serve-sharding tp

Without a mesh `--serve-sharding` changes nothing.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM: serve on a (data, model) mesh of gloo ranks")
    ap.add_argument("--serve-sharding", choices=("train", "tp"),
                    default="train")
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh, run_ranks
        return run_ranks(_serve, parse_mesh(args.mesh), device=args.device,
                         args=(args,))
    return _serve(None, args)


def _serve(mesh, args):
    """Serve on `mesh` (None: one device); rank 0 prints the tokens."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    params = LM(cfg).init(torch.Generator().manual_seed(0),
                          device=args.device)
    eng = ServeEngine(cfg, params, batch=args.batch, max_len=args.max_len,
                      device=args.device, mesh=mesh,
                      serve_sharding=args.serve_sharding)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab, rng.integers(3, 9),
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    results = eng.generate(reqs)
    if mesh is not None:
        import torch.distributed as dist
        if dist.get_rank():
            return None
    for uid in sorted(results):
        print(f"req {uid}: {results[uid]}")
    return results


if __name__ == "__main__":
    main()
