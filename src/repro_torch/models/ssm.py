"""Linear-attention / SSM substrate (port of `repro/models/ssm.py`): the
chunked training scan and the recurrent decode shared by Mamba2 (SSD,
per-head scalar decay) and RWKV6 (Finch, data-dependent per-channel
decay), the causal depthwise conv1d, and the two blocks.

The recurrence (per head, state S in R^{dk x dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = q_t^T S_{t'}  (+ u-bonus diagonal term for RWKV)
with t' = t (Mamba2 reads the post-update state) or t-1 (RWKV reads the
pre-update state, the current token entering through the u bonus).

`chunked_linear_attention` is `repro`'s chunk-parallel form: within a
chunk of T tokens the strictly-lower-triangular part is a dense attention
product with relative decay exp(A_i - A_j), and the state carries across
chunks; per-step log-decay is clamped to `log_decay_min(T)`, all in fp32.
`repro` does each chunk's work inside its scan body.  A chunk's internal
terms do not read the carried state, so here they are computed for all
chunks at once, and only the carry -- S = S * exp(A_last) + K_T^T V, in
chunk order, one fused multiply-add a chunk -- is a loop.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, trunc_normal


def log_decay_min(chunk: int) -> float:
    return -80.0 / chunk


def chunked_linear_attention(q, k, v, log_w, *, chunk: int,
                             u: Optional[torch.Tensor] = None,
                             state0: Optional[torch.Tensor] = None,
                             pre_update_read: bool = False):
    """q,k,log_w (B,S,H,dk); v (B,S,H,dv); u (H,dk) or None.

    Returns (y (B,S,H,dv) in q's dtype, final_state (B,H,dk,dv) fp32).
    pre_update_read=True gives the RWKV semantics (y reads S_{t-1}; the
    diagonal term is weighted by u), False the Mamba2/SSD semantics
    (y reads S_t; diagonal weight 1)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    T = min(chunk, S)
    pad = (-S) % T
    if pad:
        # Zero k/v and log_w=0 (w=1) leave the carried state untouched.
        def zpad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        q, k, v, log_w = zpad(q), zpad(k), zpad(v), zpad(log_w)
    nc = (S + pad) // T
    log_w = torch.clamp(log_w.float(), log_decay_min(T), 0.0)

    def rs(x):  # (B,S_pad,...) -> (B,nc,T,...)
        return x.reshape(B, nc, T, *x.shape[2:])

    qc, kc, vc, wc = rs(q.float()), rs(k.float()), rs(v.float()), rs(log_w)
    dcoef = torch.ones((H, dk), dtype=torch.float32, device=q.device) \
        if u is None else u.float()
    tri = torch.tril(torch.ones((T, T), dtype=torch.float32,
                                device=q.device), diagonal=-1)

    A = torch.cumsum(wc, dim=2)               # inclusive cumlog decay
    A_q = A - wc if pre_update_read else A
    q_s = qc * torch.exp(A_q)                 # exp <= 1
    k_s = kc * torch.exp(-A)                  # exp <= e^{80}
    att = torch.einsum("bnihd,bnjhd->bnhij", q_s, k_s) * tri
    y = torch.einsum("bnhij,bnjhe->bnihe", att, vc)
    diag = torch.einsum("bnihd,bnihd,hd->bnih", qc, kc, dcoef)
    y = y + diag[..., None] * vc
    A_last = A[:, :, -1:]                     # (B,nc,1,H,dk)
    k_T = kc * torch.exp(A_last - A)          # exp <= 1
    kv = torch.einsum("bnjhd,bnjhe->bnhde", k_T, vc)
    decay = torch.exp(A_last[:, :, 0])[..., None]             # (B,nc,H,dk,1)

    state = state0.float() if state0 is not None else \
        torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    # unbind, not kv[:, n]: the backward then stacks the chunks' gradients
    # once, where indexing would scatter each into a zeroed copy of kv.
    entering = []
    for kv_n, decay_n in zip(kv.unbind(1), decay.unbind(1)):
        entering.append(state)
        state = torch.addcmul(kv_n, state, decay_n)
    y = y + torch.einsum("bnihd,bnhde->bnihe", q_s,
                         torch.stack(entering, dim=1))
    y = y.reshape(B, nc * T, H, dv)[:, :S]
    return y.to(q.dtype), state


def linear_attention_decode(q, k, v, log_w, state, *, u=None,
                            pre_update_read: bool = False):
    """One-token recurrent step.  q,k,log_w (B,H,dk), v (B,H,dv),
    state (B,H,dk,dv) -> (y (B,H,dv), new_state)."""
    log_w = torch.clamp(log_w.float(), -80.0, 0.0)
    w = torch.exp(log_w)
    kf, vf, qf = k.float(), v.float(), q.float()
    new_state = state * w[..., None] + kf[..., None] * vf[..., None, :]
    read = state if pre_update_read else new_state
    y = torch.einsum("bhd,bhde->bhe", qf, read)
    if pre_update_read:
        dcoef = torch.ones_like(kf) if u is None else u.float()
        y = y + torch.einsum("bhd,bhd->bh", qf * dcoef, kf)[..., None] * vf
    return y.to(q.dtype), new_state


def recurrent_reference(q, k, v, log_w, *, u=None, pre_update_read=False,
                        state0=None):
    """Step-by-step oracle for the chunked scan (tests)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    s = state0 if state0 is not None else torch.zeros(
        (B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        y, s = linear_attention_decode(q[:, t], k[:, t], v[:, t],
                                       log_w[:, t], s, u=u,
                                       pre_update_read=pre_update_read)
        ys.append(y)
    return torch.stack(ys, dim=1), s


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (Mamba's short conv): stride 1, so the tap sum
# below is the zero-free schedule.
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (K,C) depthwise causal: y[t] = sum_k w[k] x[t-K+1+k]."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for kk in range(K):
        y = y + xp[:, kk:kk + S, :].float() * w[kk]
    return y.to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor):
    """x_t (B,C), conv_state (B,K-1,C) of previous inputs -> (y (B,C),
    the next conv_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------

def mamba2_init(generator: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    s = 1 / math.sqrt(d)
    return {
        # z, x, B, C, dt fused input projection
        "in_proj": trunc_normal(generator, (d, 2 * di + 2 * n + H), s),
        "conv_w": trunc_normal(generator, (cfg.ssm_conv, di + 2 * n), 0.5),
        "A_log": torch.zeros((H,), dtype=torch.float32),
        "dt_bias": torch.zeros((H,), dtype=torch.float32),
        "D": torch.ones((H,), dtype=torch.float32),
        "norm_scale": torch.zeros((di,), dtype=torch.float32),
        "out_proj": trunc_normal(generator, (di, d), 1 / math.sqrt(di)),
    }


def _mamba_parts(params, x, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, H], dim=-1)
    return z, xbc, dt_raw, di, n, H


def _mamba_ssm_inputs(params, xbc, dt_raw, cfg, di, n, H):
    xs, B_in, C_in = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = torch.exp(params["A_log"])                # (H,) positive
    log_w = (-dt * A)[..., None]                  # (..., H, 1)
    lead = xs.shape[:-1]
    xs = xs.reshape(*lead, H, cfg.ssm_head_dim)
    v = xs * dt[..., None].to(xs.dtype)
    k = B_in[..., None, :].expand(*lead, H, n).to(xs.dtype)
    q = C_in[..., None, :].expand(*lead, H, n).to(xs.dtype)
    log_w = log_w.expand(*lead, H, n)
    return xs, q, k, v, log_w


def _mamba_out(params, y, xs, z, x, cfg, di):
    """The skip term, the gated norm and the output projection."""
    y = y + params["D"].to(x.dtype)[:, None] * xs
    y = y.reshape(*xs.shape[:-2], di)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    y = y * F.silu(z)
    return y @ params["out_proj"].to(x.dtype)


def mamba2_block(params, x, cfg: ModelConfig):
    """x (B,S,D) -> (B,S,D) (training / prefill)."""
    return mamba2_prefill(params, x, cfg)[0]


def mamba2_prefill(params, x, cfg: ModelConfig):
    """x (B,S,D) -> (out (B,S,D), the conv inputs' last K-1 positions
    (B,K-1,C), the final SSM state (B,H,n,dh)): `repro`'s
    `mamba_prefill` less its residual."""
    z, xbc, dt_raw, di, n, H = _mamba_parts(params, x, cfg)
    xbc_a = F.silu(causal_conv1d(xbc, params["conv_w"]))
    xs, q, k, v, log_w = _mamba_ssm_inputs(params, xbc_a, dt_raw, cfg, di, n,
                                           H)
    y, st = chunked_linear_attention(q, k, v, log_w, chunk=cfg.chunk_size)
    return (_mamba_out(params, y, xs, z, x, cfg, di),
            xbc[:, -(cfg.ssm_conv - 1):], st)


def mamba2_decode(params, x, cfg: ModelConfig, conv_state, ssm_state):
    """x (B,1,D); conv_state (B,K-1,C); ssm_state (B,H,n,dh) -> (out
    (B,1,D), conv_state, ssm_state)."""
    z, xbc, dt_raw, di, n, H = _mamba_parts(params, x[:, 0], cfg)
    xbc, conv_state = causal_conv1d_step(xbc, conv_state, params["conv_w"])
    xbc = F.silu(xbc)
    xs, q, k, v, log_w = _mamba_ssm_inputs(params, xbc, dt_raw, cfg, di, n, H)
    y, ssm_state = linear_attention_decode(q, k, v, log_w, ssm_state)
    return (_mamba_out(params, y, xs, z, x[:, 0], cfg, di)[:, None, :],
            conv_state, ssm_state)


# ---------------------------------------------------------------------------
# RWKV6 block (Finch): data-dependent per-channel decay
# ---------------------------------------------------------------------------

def rwkv6_init(generator: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    dk = cfg.ssm_head_dim
    H = d // dk
    low = 64  # decay LoRA rank
    s = 1 / math.sqrt(d)
    return {
        "mu": torch.full((5, d), 0.5),             # r,k,v,w,g token-shift
        "wr": trunc_normal(generator, (d, d), s),
        "wk": trunc_normal(generator, (d, d), s),
        "wv": trunc_normal(generator, (d, d), s),
        "wg": trunc_normal(generator, (d, d), s),
        "w0": torch.full((d,), -6.0),
        "w1": trunc_normal(generator, (d, low), s),
        "w2": trunc_normal(generator, (low, d), 1 / math.sqrt(low)),
        "u": trunc_normal(generator, (H, dk), 1.0),
        "ln_scale": torch.zeros((d,), dtype=torch.float32),
        "wo": trunc_normal(generator, (d, d), s),
        # channel mix
        "mu_c": torch.full((2, d), 0.5),
        "ck": trunc_normal(generator, (d, cfg.d_ff), s),
        "cr": trunc_normal(generator, (d, d), s),
        "cv": trunc_normal(generator, (cfg.d_ff, d), 1 / math.sqrt(cfg.d_ff)),
    }


def _token_shift(x, x_prev):
    """x (B,S,D); x_prev (B,1,D) last token of the previous segment."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _rwkv_qkvwg(params, x, xs, cfg):
    dt = x.dtype
    d = x.shape[-1]
    dk = cfg.ssm_head_dim
    H = d // dk
    mu = params["mu"]
    xr, xk, xv, xw, xg = ((x + mu[i] * (xs - x)).to(dt) for i in range(5))
    lead = x.shape[:-1]
    r = (xr @ params["wr"].to(dt)).reshape(*lead, H, dk)
    k = (xk @ params["wk"].to(dt)).reshape(*lead, H, dk)
    v = (xv @ params["wv"].to(dt)).reshape(*lead, H, dk)
    g = xg @ params["wg"].to(dt)
    # Data-dependent decay (the Finch contribution), in fp32:
    ww = params["w0"] + torch.tanh(
        xw.float() @ params["w1"].float()) @ params["w2"].float()
    log_w = -torch.exp(ww).reshape(*lead, H, dk)
    return r, k, v, g, log_w


def _rwkv_out(params, y, g, x, cfg):
    y = rmsnorm({"scale": params["ln_scale"]}, y, cfg.norm_eps)
    return (y * F.silu(g)) @ params["wo"].to(x.dtype)


def rwkv6_time_mix(params, x, cfg: ModelConfig, x_prev=None):
    """Returns (out, x_last (B,1,D), state (B,H,dk,dk)) for caching."""
    B, S, D = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, 1, D))
    r, k, v, g, log_w = _rwkv_qkvwg(params, x, _token_shift(x, x_prev), cfg)
    y, state = chunked_linear_attention(
        r, k, v, log_w, chunk=cfg.chunk_size, u=params["u"],
        pre_update_read=True)
    return _rwkv_out(params, y.reshape(B, S, D), g, x, cfg), x[:, -1:], state


def rwkv6_time_mix_decode(params, x, cfg: ModelConfig, x_prev, state):
    """x (B,1,D); x_prev (B,1,D); state (B,H,dk,dk)."""
    B, _, D = x.shape
    r, k, v, g, log_w = _rwkv_qkvwg(params, x[:, 0], x_prev[:, 0], cfg)
    y, state = linear_attention_decode(r, k, v, log_w, state,
                                       u=params["u"], pre_update_read=True)
    return _rwkv_out(params, y.reshape(B, D), g, x, cfg)[:, None, :], x, \
        state


def rwkv6_channel_mix(params, x, cfg: ModelConfig, x_prev=None):
    """Returns (out, x_last (B,1,D))."""
    B, S, D = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, 1, D))
    xs = _token_shift(x, x_prev)
    mu = params["mu_c"]
    dt = x.dtype
    xk = (x + mu[0] * (xs - x)).to(dt)
    xr = (x + mu[1] * (xs - x)).to(dt)
    kk = torch.square(F.relu(xk @ params["ck"].to(dt)))
    rr = torch.sigmoid(xr @ params["cr"].to(dt))
    return rr * (kk @ params["cv"].to(dt)), x[:, -1:]
