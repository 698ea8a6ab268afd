"""Training launcher (port of `repro/launch/train.py`): the LM trained
through `train/trainer.py::Trainer` on the deterministic token stream,
random params from `--seed`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 3 --seq-len 4096 --global-batch 8

Without `--device` it runs on the card (and fails without one).  `--smoke`
takes the reduced config.  The step accumulates the config's microbatches
(`effective_microbatches`: qwen3-0.6b's 4 at global batch 8).

`--mesh DxM` trains on a ("data", "model") mesh of D*M `gloo` ranks
(`launch/mesh.py::run_ranks`: spawned here, or the ranks `torchrun`
started), any family; rank 0 prints the losses:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --device cpu --steps 4 --mesh 2x2

`repro`'s TPU XLA flags, `jax.distributed` and its production meshes
(`--multi-pod`, 16 x 16 ranks) have no counterpart here.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh of gloo ranks")
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh, run_ranks
        return run_ranks(_train, parse_mesh(args.mesh), device=args.device,
                         args=(args,))
    return _train(None, args)


def _train(mesh, args):
    """Train on `mesh` (None: one device); rank 0 prints the losses."""

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.seed,
                      embed_dim=cfg.d_model if cfg.embed_input else None)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, seed=args.seed)
    trainer = Trainer(cfg, ds, AdamWConfig(lr=args.lr,
                                           total_steps=args.steps),
                      tcfg, mesh=mesh, device=args.device)
    out = trainer.run()
    if mesh is not None:
        import torch.distributed as dist
        if dist.get_rank():
            return None
        out = {"history": out["history"]}
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
