"""Blockwise (flash) causal GQA attention: the CUDA kernel
`csrc/flash_attention.cu` and its plain PyTorch version (port of
`repro/kernels/attention.py`).

    out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h // g]) v[b, j, h // g]

with q (B,Sq,Hq,D), k/v (B,Sk,Hk,D), g = Hq / Hk, scale = D**-0.5, and,
when causal, key j visible to query i iff j <= q_offset + i
(`q_offset` defaults to Sk - Sq: the queries are the last Sq positions).
Both versions run the same online-softmax recurrence over kv blocks:
running max m (initially -1e30), normalizer l and an fp32 accumulator,
masked scores -1e30, output acc / max(l, 1e-30) in q's dtype.
Public entry: `kernels/ops.py::flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernel's instantiations
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}

# q, k, v, out; B, Sq, Sk, Hq, Hk, D, causal, q_offset; scale; the
# (batch, sequence, head) strides of q, k, v and out; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_float]
             + [ctypes.c_int64] * 12 + [ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int | None = None,
                          blk_k: int = 128) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hk,D), Hq % Hk == 0 -> (B,Sq,Hq,D).

    The recurrence over kv blocks of `blk_k` keys, on whole tensors; with
    `causal` it stops after the last block a query can see (the blocks
    past it would add p = 0 and scale by exp(0) = 1, changing nothing)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    g = Hq // Hk
    off = Sk - Sq if q_offset is None else q_offset
    qf = (q.float() * D ** -0.5).reshape(B, Sq, Hk, g, D)
    q_pos = off + torch.arange(Sq, device=q.device)
    acc = torch.zeros((B, Sq, Hk, g, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hk, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hk, g), dtype=torch.float32, device=q.device)
    kv_end = min(Sk, off + Sq) if causal else Sk
    for kv0 in range(0, kv_end, blk_k):
        kb = k[:, kv0:kv0 + blk_k].float()
        vb = v[:, kv0:kv0 + blk_k].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        if causal:
            k_pos = kv0 + torch.arange(kb.shape[1], device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def check_operand(name: str, t: torch.Tensor) -> None:
    """The kernel reads 16 bytes at a time along D from any (batch,
    sequence, head) strides, so a view such as the live prefix of a KV
    cache goes in as it is.  Raises on an operand it cannot read in place
    (innermost stride not 1, or a start or stride off the 16-byte grid)
    rather than copying it: a copy of the cache at every decode step
    would cost more than the attention."""
    vec = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) != 1:
        why = "needs a unit stride along D"
    elif t.data_ptr() % 16:
        why = "needs a 16-byte aligned start"
    elif any(s % vec for s in strides):
        why = f"needs strides that are multiples of {vec} elements"
    else:
        return
    raise ValueError(f"flash_attention cannot read {name} (strides "
                     f"{tuple(t.stride())}, address {t.data_ptr():#x}) in "
                     f"place: it {why}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int) -> torch.Tensor:
    """Launch the kernel on the current stream.  One device, one dtype
    (fp32 or bf16), a head_dim of HEAD_DIMS -- the wrapper in
    `kernels/ops.py` checks all three."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t)
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    symbol = _SYMBOLS[q.dtype]
    fn = build.kernel_function("flash_attention", symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hk, D, int(causal), q_offset, D ** -0.5,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
    build.check_launch("flash_attention", err)
    return out
