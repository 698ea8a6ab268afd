"""End-to-end LM training with checkpoint/restart (counterpart of
`examples/train_lm.py`).

Trains the reduced config of an architecture on the deterministic
synthetic token stream through `train/trainer.py::Trainer`: AdamW,
async checkpoints, and a simulated failure at half the steps, after which
a fresh `Trainer` resumes from the latest atomic checkpoint -- the data
skips ahead, so the resumed run replays exactly the batches it lost.
The loss must fall.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \
          [--device cpu] [--arch qwen3-0.6b] [--steps 200]

Without `--device` it runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import TokenDataset
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step, then restart")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0,
                      embed_dim=cfg.d_model if cfg.embed_input else None)

    def trainer(tcfg):
        return Trainer(cfg, ds, AdamWConfig(lr=3e-3, warmup_steps=20,
                                            total_steps=args.steps),
                       tcfg, device=args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                             ckpt_every=max(10, args.steps // 10),
                             log_every=max(5, args.steps // 20))
        fail_at = args.fail_at or args.steps // 2
        print(f"training {args.arch} (reduced) for {args.steps} steps; "
              f"injecting failure at step {fail_at}...")
        t0 = time.time()
        try:
            trainer(tcfg).run(fail_at_step=fail_at)
        except RuntimeError as e:
            print(f"  !! {e} -- restarting from the latest checkpoint")
        # "restart": a fresh Trainer picks up the latest atomic ckpt
        out = trainer(tcfg).run()
        dt = time.time() - t0
        for h in out["history"]:
            print(f"  step {h['step']:5d}  loss {h['loss']:.4f}")
        first, last = out["history"][0], out["history"][-1]
        print(f"\ndone in {dt:.1f}s; loss {first['loss']:.3f} -> "
              f"{last['loss']:.3f} (resumed across a simulated failure)")
        assert last["loss"] < first["loss"] + 1e-6
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    return out


if __name__ == "__main__":
    main()
