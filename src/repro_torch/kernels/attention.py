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
With `return_lse` both also give each row's log-sum-exp (B, Hq, Sq),
lse = m + log(max(l, 1e-30)), from which the backward recomputes
P = exp(scale q.k - lse).  Public entry: `kernels/ops.py::flash_attention`.

The kernel has three forms, and `plan` picks one per call from the
shapes alone:
  * "split": at most SPLIT_MAX_ROWS (query, head-of-group) rows per kv
    head -- the engine's decode step, Sq = 1 -- in fp32 or bf16.  A
    thread-block cluster of `splits` CTAs per (batch, kv head), each
    over a slice of the keys; the partial (m, l, acc) are combined in
    the cluster in a fixed order (`split_kv_plain` is that arithmetic).
  * "wgmma": bf16 with a head_dim of WGMMA_DIMS and at least one
    64-row tile of (query, head-of-group) rows -- prefill.  Tensor-core
    products, P split into two bf16 terms, p_hi = bf16(p) and p_lo =
    bf16(p - p_hi), so that P.V keeps ~16 bits of P as the fp32 P of
    this plain version does.
  * "tile": everything else (fp32 prefill, head_dim 16, 32 or 80): fp32
    SIMT, one CTA per (b, h, 16 query rows).

The dry-run traces the LM on fake tensors (`torch._subclasses.
fake_tensor`), which hold shapes and no data.  On a fake operand
`flash_attention_cuda` and `flash_attention_backward_cuda` run their
shape-only forms: the same checks and the same output allocations as a
launch, then a return before anything is built or launched; each adds
its operations to FAKE_FLOPS (4 D a visible (query, key) pair forward,
10 D backward: the two and five products of D multiply-adds).  Neither
kernel allocates device memory besides those outputs (the split form
combines its partials in the cluster's shared memory), so the fake
forms allocate every byte a launch does.  They count their calls by
kernel and form in FAKE_CALLS and FAKE_FORMS, which the dry-run reports
as the launches the card would make; `ops.LAUNCHES` and its form counts
stay those of real launches.  A real tensor never takes them.

The backward, `csrc/flash_attention_bwd.cu`, and its plain version
`flash_attention_backward_plain` compute dq, dk, dv from q, k, v, the
output, its cotangent and the lse: three launches (delta = dO . o; dk
and dv per block of keys, summing the GQA group's heads in order; dq per
block of queries), no atomics.  `backward_plan` picks its form:
  * "wgmma": bf16 at a head_dim of BWD_WGMMA_DIMS -- tensor-core
    products fed by TMA, P and dS each split into two bf16 terms as the
    forward splits P;
  * "simt": everything else (fp32, head_dim 16, 32, 80 and 256): fp32
    FMAs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the kernel's instantiations
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
FORMS = ("tile", "wgmma", "split")      # the C entry's form codes, in order
WGMMA_DIMS = (64, 128, 256)
WGMMA_ROWS = 64          # rows of one wgmma tile
SPLIT_MAX_ROWS = 8       # rows a split-form CTA holds
SPLIT_TILE = 64          # keys per kv tile of the split form
SPLIT_WARP_KEYS = 32     # keys of a tile each of its two warps takes
MAX_SPLITS = 8           # the portable thread-block cluster size
SM_COUNT = 132           # H100 SXM

# q, k, v, out, lse (or None); B, Sq, Sk, Hq, Hk, D, causal, q_offset;
# scale; the (batch, sequence, head) strides of q, k, v and out; form,
# splits; the stream.
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 8 + [ctypes.c_float]
             + [ctypes.c_int64] * 14 + [ctypes.c_void_p])
_BWD_SYMBOLS = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}
BWD_FORMS = ("simt", "wgmma")    # the backward C entry's form codes
# The wgmma form's head_dims: at 256 one warpgroup's dK and dV for 64 keys
# alone would need 256 registers a thread.
BWD_WGMMA_DIMS = (64, 128)
# q, k, v, out, dout, lse, delta, dq, dk, dv; B, Sq, Sk, Hq, Hk, D, causal,
# q_offset; scale; form; the stream.
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 8
                 + [ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])


# The fake forms' calls since the last reset (`ops.reset_launches`), by
# kernel and by form, and their operations: the dry-run's count of the
# launches the card would make and of the work the kernels would do.
FAKE_CALLS = {"flash_attention": 0, "flash_attention_backward": 0}
FAKE_FORMS = {"forward": dict.fromkeys(FORMS, 0),
              "backward": dict.fromkeys(BWD_FORMS, 0)}
FAKE_FLOPS = dict.fromkeys(FAKE_CALLS, 0)


def is_fake(t: torch.Tensor) -> bool:
    """True for a fake tensor (shapes, no data)."""
    from torch._subclasses.fake_tensor import is_fake as fake
    return fake(t)


def visible_pairs(Sq: int, Sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs one head computes: query i sees keys
    0 .. q_offset + i when causal (at most Sk of them), else all Sk."""
    if not causal:
        return Sq * Sk
    full = max(0, min(Sq, Sk - q_offset))   # queries seeing fewer than Sk
    return full * (2 * q_offset + full + 1) // 2 + (Sq - full) * Sk


class AttentionPlan(NamedTuple):
    form: str       # one of FORMS
    splits: int     # CTAs per (batch, kv head) of the split form, else 1


def plan(dtype: torch.dtype, B: int, Sq: int, Sk: int, Hq: int, Hk: int,
         D: int) -> AttentionPlan:
    """The kernel form for these shapes.  Rows are the (query, head of a
    GQA group) pairs of one kv head, Sq * Hq / Hk.

    Split-kv when a kv head has at most SPLIT_MAX_ROWS rows: `splits`
    CTAs per (b, kv head), enough for two per SM (2 * SM_COUNT in all)
    but at most MAX_SPLITS (one cluster) and at most one per SPLIT_TILE
    keys; then as few as give each split the same number of tiles, so
    that no split is empty.  Otherwise the tensor-core form for bf16 at
    a head_dim of WGMMA_DIMS with a whole 64-row tile, and the SIMT tile
    form for the rest."""
    rows = Sq * (Hq // Hk)
    if rows <= SPLIT_MAX_ROWS:
        tiles = -(-Sk // SPLIT_TILE)
        want = -(-2 * SM_COUNT // (B * Hk))
        splits = max(1, min(MAX_SPLITS, want, tiles))
        per = -(-tiles // splits)
        return AttentionPlan("split", -(-tiles // per))
    if dtype == torch.bfloat16 and D in WGMMA_DIMS and rows >= WGMMA_ROWS:
        return AttentionPlan("wgmma", 1)
    return AttentionPlan("tile", 1)


def backward_plan(dtype: torch.dtype, B: int, Sq: int, Sk: int, Hq: int,
                  Hk: int, D: int) -> str:
    """The backward kernel's form for these shapes: "wgmma" for bf16 at a
    head_dim of BWD_WGMMA_DIMS, whatever the lengths (ragged rows and
    keys arrive as zeros and are masked), else "simt" -- fp32 stays fp32
    (TF32 would leave its class), head_dim 16 / 32 are narrower than the
    form's 64-column tile panels, 80 is no whole number of them, and 256
    would not fit its registers."""
    del B, Sq, Sk, Hq, Hk    # the rule reads the dtype and head_dim alone
    if dtype == torch.bfloat16 and D in BWD_WGMMA_DIMS:
        return "wgmma"
    return "simt"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int | None = None,
                          blk_k: int = 128, return_lse: bool = False):
    """q (B,Sq,Hq,D), k/v (B,Sk,Hk,D), Hq % Hk == 0 -> (B,Sq,Hq,D), and
    with `return_lse` also the rows' log-sum-exps (B,Hq,Sq) in fp32.

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
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l_safe)).permute(0, 2, 3, 1).reshape(B, Hq, Sq)
    return out, lse


def flash_attention_backward_plain(q, k, v, out, dout, lse, *,
                                   causal: bool = True,
                                   q_offset: int | None = None,
                                   blk_k: int = 128):
    """(dq, dk, dv) of `flash_attention_plain` at cotangent `dout`, from
    its output `out` and lse (B,Hq,Sq), in q's dtype: block-wise over kv
    blocks of `blk_k` keys with the kernel's formulas, not autograd,
        P = exp(scale q.k - lse) (0 where not visible),  dV = P^T dO,
        dS = P (dO.v - delta),  delta = dO . out,
        dQ = scale dS K,  dK = scale dS^T Q,
    the GQA group's heads summed into their kv head.  Keys no query sees
    get 0."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    g = Hq // Hk
    off = Sk - Sq if q_offset is None else q_offset
    scale = D ** -0.5
    shape = (B, Sq, Hk, g, D)
    qf = (q.float() * scale).reshape(shape)
    dof = dout.float().reshape(shape)
    delta = (dof * out.float().reshape(shape)).sum(dim=-1)    # (B,Sq,Hk,g)
    lse_ = lse.float().reshape(B, Hk, g, Sq).permute(0, 3, 1, 2)
    q_pos = off + torch.arange(Sq, device=q.device)
    dq = torch.zeros(shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, Hk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kv_end = min(Sk, off + Sq) if causal else Sk
    for kv0 in range(0, kv_end, blk_k):
        kb = k[:, kv0:kv0 + blk_k].float()
        vb = v[:, kv0:kv0 + blk_k].float()
        n = kb.shape[1]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        p = torch.exp(s - lse_[..., None])
        if causal:
            k_pos = kv0 + torch.arange(n, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            p = torch.where(mask[None, :, None, None, :], p, 0.0)
        dv[:, kv0:kv0 + n] = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dk[:, kv0:kv0 + n] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf)
    return ((dq * scale).reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def split_kv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, q_offset: int | None = None,
                   splits: int = 1) -> torch.Tensor:
    """The split form's arithmetic on whole tensors.  Split s takes the
    keys [s * chunk, (s + 1) * chunk), chunk a whole number of SPLIT_TILE
    tiles; warp w of its CTA the keys whose place in their tile lies in
    [32 w, 32 w + 32).  Each (split, warp) runs the recurrence over its
    32-key blocks alone -- a masked key adds p = 0, and a partial that
    sees no key keeps m = -1e30, l = 0 -- and the partials are combined
    in the order (split, warp): with M = max m_p and w_p = exp(m_p - M),
        out = sum w_p acc_p / max(sum w_p l_p, 1e-30).
    Split 0 holds key 0, which every row sees, so M is finite and an
    empty partial weighs exp(-1e30 - M) = 0."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    g = Hq // Hk
    off = Sk - Sq if q_offset is None else q_offset
    qf = (q.float() * D ** -0.5).reshape(B, Sq, Hk, g, D)
    q_pos = off + torch.arange(Sq, device=q.device)
    kv_end = min(Sk, off + Sq) if causal else Sk
    tiles = -(-Sk // SPLIT_TILE)
    chunk = -(-tiles // splits) * SPLIT_TILE
    shape = (B, Sq, Hk, g)
    parts = []
    for s in range(splits):
        for w in range(SPLIT_TILE // SPLIT_WARP_KEYS):
            m = torch.full(shape, NEG_INF, device=q.device)
            l = torch.zeros(shape, device=q.device)
            acc = torch.zeros(shape + (D,), device=q.device)
            for t0 in range(s * chunk, min((s + 1) * chunk, kv_end),
                            SPLIT_TILE):
                kv0 = t0 + w * SPLIT_WARP_KEYS
                if kv0 >= kv_end:
                    break
                kb = k[:, kv0:kv0 + SPLIT_WARP_KEYS].float()
                vb = v[:, kv0:kv0 + SPLIT_WARP_KEYS].float()
                k_pos = kv0 + torch.arange(kb.shape[1], device=q.device)
                live = k_pos[None, :] < kv_end
                if causal:
                    live = live & (k_pos[None, :] <= q_pos[:, None])
                live = live[None, :, None, None, :]
                s_blk = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
                s_blk = torch.where(live, s_blk, NEG_INF)
                m_new = torch.maximum(m, s_blk.amax(dim=-1))
                p = torch.where(live, torch.exp(s_blk - m_new[..., None]),
                                0.0)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bqhgk,bkhd->bqhgd", p, vb)
                m = m_new
            parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum = torch.zeros(shape, device=q.device)
    acc_sum = torch.zeros(shape + (D,), device=q.device)
    for m, l, acc in parts:
        wgt = torch.exp(m - M)
        l_sum = l_sum + wgt * l
        acc_sum = acc_sum + wgt[..., None] * acc
    out = acc_sum / torch.clamp_min(l_sum, 1e-30)[..., None]
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
    elif not is_fake(t) and t.data_ptr() % 16:     # a fake one has none
        why = "needs a 16-byte aligned start"
    elif any(s % vec for s in strides):
        why = f"needs strides that are multiples of {vec} elements"
    else:
        return
    raise ValueError(f"flash_attention cannot read {name} (strides "
                     f"{tuple(t.stride())}, address {t.data_ptr():#x}) in "
                     f"place: it {why}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int,
                         form: AttentionPlan, return_lse: bool = False):
    """Launch the kernel's `form` (from `plan`) on the current stream.
    One device, one dtype (fp32 or bf16), a head_dim of HEAD_DIMS -- the
    wrapper in `kernels/ops.py` checks all three.  With `return_lse` the
    kernel also writes the rows' log-sum-exps: (out, lse (B,Hq,Sq) fp32);
    without, it writes none, bit for bit the launch serving makes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t)
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if is_fake(q):
        FAKE_CALLS["flash_attention"] += 1
        FAKE_FORMS["forward"][form.form] += 1
        FAKE_FLOPS["flash_attention"] += \
            4 * D * B * Hq * visible_pairs(Sq, Sk, causal, q_offset)
        return (out, lse) if return_lse else out
    symbol = _SYMBOLS[q.dtype]
    fn = build.kernel_function("flash_attention", symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, Sk, Hq, Hk, D, int(causal), q_offset, D ** -0.5,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], FORMS.index(form.form), form.splits,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("flash_attention", err)
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q, k, v, out, dout, lse, *, causal: bool,
                                  q_offset: int, form: str):
    """Launch `csrc/flash_attention_bwd.cu`'s `form` (from
    `backward_plan`; three kernels) on the current stream -- on
    autograd's backward thread that is the stream the forward's consumers
    ran on.  Every operand must be contiguous, and q, k, v, out and dout
    of one dtype (fp32 or bf16); lse is fp32 (B,Hq,Sq).  A form the
    shapes do not take is refused by the kernel's entry and raises.
    Returns (dq, dk, dv) in q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_backward needs a contiguous "
                             f"{name}, got strides {tuple(t.stride())}")
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq):
        raise ValueError(f"lse must be float32 {(B, Hq, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if is_fake(q):
        FAKE_CALLS["flash_attention_backward"] += 1
        FAKE_FORMS["backward"][form] += 1
        FAKE_FLOPS["flash_attention_backward"] += \
            10 * D * B * Hq * visible_pairs(Sq, Sk, causal, q_offset)
        return dq, dk, dv
    fn = build.kernel_function("flash_attention_bwd", _BWD_SYMBOLS[q.dtype],
                               _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq,
                 Hk, D, int(causal), q_offset, D ** -0.5,
                 BWD_FORMS.index(form),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("flash_attention_bwd", err)
    return dq, dk, dv
