"""The LM decode step on the card, compiled once: the port's counterpart
of `repro`'s `jax.jit(self.lm.decode_step)` (`repro/serve/engine.py:44`).

Eager PyTorch pays the host's dispatch for every op of every decode
step -- thousands of small kernels a step, the device idle most of it.
A `torch.cuda.CUDAGraph` records the whole step once and each replay
queues it with one launch.  `repro`'s jitted step takes the cache length
as a traced int32 scalar; here the step is `LM.decode_step`'s graph form
(`models/lm.py`): the length is a 0-d int32 tensor on the card, which
RoPE, the cache writes (`index_copy_`) and the split attention kernel
read where it lies, and which the step advances in place.

What the graph cannot take by value is the attention's view of the
cache: its extent sizes the kernel's grid.  So there is one graph per
BUCKET of extents, powers of two in SPLIT_TILE (64) keys capped at
max_len (`buckets`): at max_len 2048, 64, 128, ..., 2048, six graphs at
most.  A step at cache length n runs in the smallest bucket that holds
n + 1 keys (`bucket`); a cache with no attention (rwkv6's) needs one
graph, at max_len.  Each graph is captured at its bucket's first step,
and all share one memory pool.

The graph reads fixed buffers and writes fixed buffers:

  * inputs: the cache, one set of (batch, max_len) buffers held for the
    object's life (`load` copies each prefill's cache into them and sets
    the device length; `host_len` mirrors it), and a (batch, 1) token
    buffer;
  * outputs: the logits (batch, 1, vocab) fp32 and the next tokens (the
    greedy argmax), which the caller reads on the host.

A step executes when eager but only records under capture, so the first
step in a bucket runs the same graph-form code eagerly, on the capture
stream, as the real step whose result is used; that run also makes the
kernels' one-time calls (`cudaFuncSetAttribute`, cuBLAS's workspace for
the stream).  The capture follows, and the bucket's next step is its
first replay.  `captures` counts captures.  The kernel wrappers (and
`ops.LAUNCHES`) run only at the eager step and the capture of each
bucket; the capture records how many launches each wrapper made in it,
and every replay adds those to `replay_launches` (a replay calls no
wrapper: a profiler trace shows its kernels).  A capture
that fails -- an op that reads a device value back to the host, say --
raises: there is no eager fallback on the card.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.device import eager_then_capture
from repro_torch.kernels.attention import SPLIT_TILE


def buckets(max_len: int) -> tuple:
    """The extents of the decode graphs for a cache of `max_len`
    positions: SPLIT_TILE * 2**i below max_len, then max_len itself."""
    out, e = [], SPLIT_TILE
    while e < max_len:
        out.append(e)
        e *= 2
    return tuple(out) + (max_len,)


def bucket(live: int, max_len: int) -> int:
    """The smallest extent of `buckets(max_len)` that holds `live` keys
    (a step at cache length n attends n + 1)."""
    if not 1 <= live <= max_len:
        raise ValueError(f"{live} live keys do not fit a cache of {max_len} "
                         f"positions")
    return next(e for e in buckets(max_len) if e >= live)


class DecodeGraph:
    """`lm.decode_step(params, cache, tokens)` on one CUDA device, one
    graph per bucket.  `load(cache)` takes a prefill's cache, `step(tokens)`
    runs one decode step and returns the (logits, next tokens) buffers,
    valid until the next `step`."""

    def __init__(self, lm, params, batch: int, max_len: int,
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a DecodeGraph runs on a CUDA device, got "
                             f"{device}")
        self.lm, self.params = lm, params
        self.max_len, self.device = max_len, device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.cache = None
        self.host_len = 0
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64,
                                  device=device)
        self.logits = torch.zeros((batch, 1, lm.cfg.vocab),
                                  dtype=torch.float32, device=device)
        self.next = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.graphs = {}
        self.captures = 0
        self.launches = {}           # extent -> a capture's launches
        self.replay_launches = Counter()   # kernel -> launches replayed

    def load(self, cache) -> None:
        """Copy a prefill's cache (its "len" a Python int) into the cache
        buffers, allocated the first time, and set the device length."""
        host = {k: t for k, t in cache.items() if k != "len"}
        if self.cache is None:
            self.cache = {k: torch.empty_like(t) for k, t in host.items()}
            self.cache["len"] = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        dst = [self.cache[k] for k in host]
        if [(t.shape, t.dtype) for t in dst] != \
                [(t.shape, t.dtype) for t in host.values()]:
            raise ValueError("the cache does not match the decode graph's "
                             "buffers")
        torch._foreach_copy_(dst, list(host.values()))
        self.cache["len"].fill_(cache["len"])
        self.host_len = int(cache["len"])

    def extent(self) -> int:
        """The bucket the next step runs in."""
        live = bucket(self.host_len + 1, self.max_len)
        return live if "k" in self.cache else self.max_len

    def step(self, tokens: torch.Tensor):
        """One decode step on `tokens` (batch,) or (batch, 1) at the
        loaded cache: (logits, next tokens), the graph's output buffers."""
        if self.cache is None:
            raise RuntimeError("load a prefill's cache before step")
        extent = self.extent()
        self.tokens.copy_(tokens.reshape(self.tokens.shape))
        graph = self.graphs.get(extent)
        if graph is None:
            self._capture(extent)
        else:
            graph.replay()
            self.replay_launches.update(self.launches[extent])
        self.host_len += 1
        return self.logits, self.next

    def _step(self, extent: int) -> None:
        logits, _ = self.lm.decode_step(self.params, self.cache, self.tokens,
                                        extent=extent)
        self.logits.copy_(logits)
        self.next.copy_(torch.argmax(logits[:, 0], dim=-1))

    def _capture(self, extent: int) -> None:
        """The bucket's first step, run eagerly on the capture stream,
        then its capture (which records and runs nothing)."""
        _, graph, _, launches = eager_then_capture(
            lambda: self._step(extent), self.stream, self.pool)
        self.launches[extent] = launches
        self.graphs[extent] = graph
        self.captures += 1
