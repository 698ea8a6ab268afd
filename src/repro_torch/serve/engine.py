"""Batched LM serving engine (port of `repro/serve/engine.py`): a
continuous-batching request manager over `LM.prefill` and
`LM.decode_step`.

Requests are padded into fixed (batch, max_len) buffers; slots free as
sequences hit EOS or their length budget and are refilled from the queue
mid-flight.  Decoding is greedy (argmax, the first index on ties).  On
the card every attention of every layer is one launch of the
flash-attention kernel.

On the card (without a mesh) the decode step is compiled once, as
`repro` jits it: `serve/decode_graph.py`'s DecodeGraph holds one cache
of (batch, max_len) buffers for the engine's life, takes each
(re)prefill's cache into them, and replays one CUDA graph per
cache-length bucket (`graph.captures` counts the captures).  Three cases
stay eager, by rule: the prefill (its shapes change with every refill,
and its `wgmma` attention encodes TMA maps on the host), an engine with
a `mesh` (`gloo`'s collectives cannot be captured) and an engine on the
CPU.

With a `mesh` every rank of it runs the same engine on the same
requests: the params are laid out by `tree_shardings` in the training
layout (`serve_sharding="train"`: the weights gathered over the data
axes at every use) or the serve layout (`"tp"`: the data axes folded
into tensor parallelism, the weights resident), the cache in
`cache_pspecs`' (batch over the data axes, sequence over "model"), and
the LM's ops on the mesh issue their own collectives (`models/lm.py`).
Prompts go in whole on every rank and the logits come back whole on
every rank, equal bit for bit, so the greedy argmax and every refill
decision are the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.lm import LM
from repro_torch.parallel import sharding as sh
from repro_torch.serve.decode_graph import DecodeGraph


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 max_len: int, device=None, mesh=None,
                 serve_sharding: str = "train"):
        """`device=None` means the card (and raises without one); the
        params are moved there and, with a `mesh`, laid out by
        `serve_sharding` ("train" or "tp"; params already laid out stay
        as they are).  The prompts are tokens: a config whose
        inputs are embeddings (`embed_input`, the audio and vlm families)
        is refused, as `repro`'s engine has no embeddings path either."""
        if cfg.embed_input:
            raise ValueError(
                f"{cfg.name}: ServeEngine takes token prompts, and this "
                f"config's inputs are (B, S, D) embeddings; serve it with "
                f"LM.prefill(params, embeddings, max_len) and "
                f"LM.decode_step(params, cache, tokens)")
        if serve_sharding not in ("train", "tp"):
            raise ValueError(f"serve_sharding must be 'train' or 'tp', got "
                             f"{serve_sharding!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and not any(
                sh.is_container(t) for t in tree_leaves(params)):
            params = sh.device_put(
                tree_map(lambda t: t.to(self.device), params),
                sh.tree_shardings(params, mesh,
                                  serve=serve_sharding == "tp"))
        elif mesh is None:
            params = tree_map(lambda t: t.to(self.device), params)
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.lm = LM(cfg)
        self._prefill = lambda p, t: self.lm.prefill(p, t, max_len)
        self._decode = self.lm.decode_step
        self.graph = DecodeGraph(self.lm, self.params, batch, max_len,
                                 self.device) \
            if self.device.type == "cuda" and mesh is None else None
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
                if self.graph is not None:
                    self.graph.load(cache)
                    cache = None
                last = torch.argmax(logits[:, 0], dim=-1)
            elif self.graph is not None:
                last = self.graph.step(last)[1]
                self.stats["decode_steps"] += 1
            else:
                logits, cache = self._decode(self.params, cache,
                                             last[:, None])
                self.stats["decode_steps"] += 1
                last = torch.argmax(logits[:, 0], dim=-1)
            absorb(last.cpu().numpy())
        return results
