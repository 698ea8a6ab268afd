"""Batched LM serving engine (port of `repro/serve/engine.py`): a
continuous-batching request manager over `LM.prefill` and
`LM.decode_step`.

Requests are padded into fixed (batch, max_len) buffers; slots free as
sequences hit EOS or their length budget and are refilled from the queue
mid-flight.  Decoding is greedy (argmax, the first index on ties).  On
the card every attention of every layer is one launch of the
flash-attention kernel; there is no mesh (multi-device serving is
ROADMAP.md A.12's LM half).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 max_len: int, device=None):
        """`device=None` means the card (and raises without one); the
        params are moved there.  The prompts are tokens: a config whose
        inputs are embeddings (`embed_input`, the audio and vlm families)
        is refused, as `repro`'s engine has no embeddings path either."""
        if cfg.embed_input:
            raise ValueError(
                f"{cfg.name}: ServeEngine takes token prompts, and this "
                f"config's inputs are (B, S, D) embeddings; serve it with "
                f"LM.prefill(params, embeddings, max_len) and "
                f"LM.decode_step(params, cache, tokens)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.batch = batch
        self.max_len = max_len
        self.lm = LM(cfg)
        self._prefill = lambda p, t: self.lm.prefill(p, t, max_len)
        self._decode = self.lm.decode_step
        # generate() statistics: "refills" counts requests pulled into a
        # slot freed MID-FLIGHT; "prefills" counts batch (re)prefills.
        self.stats: Dict[str, int] = {"refills": 0, "prefills": 0,
                                      "decode_steps": 0}

    @torch.no_grad()
    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Process a list of requests with continuous batching.

        Slots free as sequences finish (EOS / length) and are refilled
        from the queue immediately, mid-flight.  The KV cache keeps one
        shared position count, so a refill re-prefills the whole batch
        over each live slot's history (prompt + tokens generated so far,
        right-aligned, pad token 0 in front, attended to as in `repro`):
        under greedy decoding the prefill's last-position argmax is the
        next decode token, so continuing slots resume where they left off
        while the new request starts in the freed slot."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        active: List[Optional[Request]] = [None] * self.batch
        cache = None
        last = None

        def absorb(arr) -> None:
            """Append one predicted token per live slot; retire slots
            that hit EOS or their length budget."""
            for i, r in enumerate(active):
                if r is None:
                    continue
                tok = int(arr[i])
                if len(r.out) < r.max_new_tokens:
                    r.out.append(tok)
                if len(r.out) >= r.max_new_tokens or (
                        r.eos_id is not None and r.out
                        and r.out[-1] == r.eos_id):
                    results[r.uid] = r.out
                    active[i] = None

        while queue or any(r is not None for r in active):
            midflight = any(r is not None for r in active)
            took = 0
            for i in range(self.batch):
                if active[i] is None and queue:
                    active[i] = queue.pop(0)
                    took += 1
            if took:
                if midflight:
                    self.stats["refills"] += took
                # (Re)prefill the whole batch over per-slot histories;
                # empty slots carry a single pad token.
                hists = [list(r.prompt) + r.out if r is not None else [0]
                         for r in active]
                plen = max(len(h) for h in hists)
                toks = np.zeros((self.batch, plen), np.int32)
                for i, h in enumerate(hists):
                    toks[i, plen - len(h):] = h   # right-aligned
                logits, cache = self._prefill(
                    self.params, torch.from_numpy(toks).to(self.device))
                self.stats["prefills"] += 1
            else:
                logits, cache = self._decode(self.params, cache,
                                             last[:, None])
                self.stats["decode_steps"] += 1
            last = torch.argmax(logits[:, 0], dim=-1)
            absorb(last.cpu().numpy())
        return results
