"""Geometry grids and seeded operands shared by the port's CPU parity
tests and its card-side tests."""
from __future__ import annotations

import numpy as np

from repro_torch.core import spec as tspec

EP_KW = [None, dict(activation="relu"),
         dict(activation="leaky_relu", slope=0.2, bias=True, scale=0.5),
         dict(activation="tanh", bias=True)]

# (stride, dilation, filter, padding, batch, out size, Cin, Cout, n_out
# slack): ragged phases (K % period != 0), residues no tap reaches
# (S > K), stride and dilation sharing a factor, anisotropic geometry.
TCONV_GRID = [
    (2, 1, 4, 1, 2, (3, 3), 3, 5, 0),
    (2, 1, 3, 1, 3, (4, 3), 4, 2, 1),
    (3, 1, 2, 1, 2, (3, 4), 4, 3, 2),
    (2, 2, 3, 1, 2, (4, 4), 3, 2, 1),
    (3, 2, 3, 2, 2, (3, 3), 2, 3, 2),
    (1, 2, 3, 2, 2, (4, 5), 3, 4, 0),
    (2, 3, 2, 0, 2, (3, 3), 2, 2, 1),
    ((2, 3), (1, 2), (3, 2), (1, 0), 2, (3, 4), 2, 3, 1),
]

FWD_GRID = [
    (1, 1, 3, 1), (2, 1, 3, 1), (1, 2, 3, 2), (1, 4, 3, 4), (2, 2, 3, 0),
    (3, 1, 2, 1), ((2, 1), (2, 3), (3, 2), (1, 2)),
]


# (name, B, N, K, S, P, D, Ci, Co): the parity grid of the fused
# backwards, `test_backward_fused.BACKWARD_GRID` (the card's tests import
# no JAX, so they read this copy; test_torch_backward.py pins the two
# equal).
BACKWARD_GRID = [
    ("s1",            2, 8,  3, 1, 1, 1, 3,  4),
    ("s2",            2, 9,  3, 2, 0, 1, 4,  4),
    ("s2_pad",        2, 9,  3, 2, 1, 1, 3,  5),
    ("s2_ragged",     2, 9,  3, 2, 1, 1, 29, 21),
    ("s3_k4",         1, 13, 4, 3, 0, 1, 2,  5),
    ("s4_klt_s",      1, 12, 2, 4, 0, 1, 5,  5),   # K < S: empty phases
    ("s2_nonexact",   2, 10, 3, 2, 0, 1, 3,  4),   # tail rows ignored
    ("s1_d2_atrous",  2, 11, 3, 1, 2, 2, 3,  3),
    ("s2_d2",         2, 14, 3, 2, 1, 2, 3,  2),   # gcd(S, D) = 2
    ("s3_d2_coprime", 1, 14, 3, 3, 0, 2, 2,  3),
    ("ragged_cin_gt_tile", 1, 7, 3, 2, 1, 1, 130, 3),
]


def backward_case(geom, seed):
    """Seeded numpy operands of one BACKWARD_GRID conv: x (B,N,N,Ci), w,
    dy and a forward output y (B,O,O,Co), a cotangent g and output z
    (B,N,N,Ci) of its transposed conv, and biases over Co and Ci."""
    _, B, N, K, S, P, D, Ci, Co = geom
    O = (N + 2 * P - (D * (K - 1) + 1)) // S + 1
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(spec=(S, P, K, D), n=(N, N), x=r(B, N, N, Ci),
                w=r(K, K, Ci, Co), dy=r(B, O, O, Co), y=r(B, O, O, Co),
                g=r(B, N, N, Ci), z=r(B, N, N, Ci), b_out=r(Co), b_in=r(Ci))


def epilogue_output(kw, y):
    """A forward output the epilogue could give: tanh's lies in (-1, 1)."""
    return np.tanh(y) if kw is not None and kw["activation"] == "tanh" \
        else y


def tconv_case(geom, seed):
    """A seeded (dy, w, bias) for one TCONV_GRID geometry, with n_out the
    exact fit plus the slack."""
    s, d, k, p, B, o, cin, cout, slack = geom
    spec = tspec.ConvSpec.make(stride=s, padding=p, filter_shape=k,
                               dilation=d)
    n_out = tuple(n + slack for n in spec.input_size(o))
    assert spec.out_size(n_out) == o
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B,) + o + (cout,)).astype(np.float32)
    w = rng.standard_normal(spec.filter_shape + (cin, cout)).astype(np.float32)
    bias = rng.standard_normal(cin).astype(np.float32)
    return spec, n_out, dy, w, bias


# (B, Sq, Sk, Hq, Hk, D, causal, bq, bk): the flash-attention sweep,
# `test_kernels.ATTN_SWEEP` (the card's tests import no JAX, so they read
# this copy; test_torch_attention.py pins the two equal).  bq and bk are
# the Pallas kernel's block sizes; the port's kernel has its own.
ATTN_SWEEP = [
    (2, 64, 64, 4, 2, 32, True, 32, 32),
    (1, 128, 128, 8, 8, 64, True, 64, 32),
    (2, 48, 96, 4, 1, 32, True, 16, 32),    # MQA, decode-style suffix
    (1, 33, 70, 8, 2, 16, False, 32, 32),   # ragged, non-causal
    (1, 1, 40, 4, 4, 32, True, 8, 16),      # single-token decode
    (2, 70, 70, 2, 2, 128, True, 32, 64),   # head_dim 128
]


def attention_case(B, Sq, Sk, Hq, Hk, D, seed):
    """Seeded numpy q (B,Sq,Hq,D), k and v (B,Sk,Hk,D)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Sq, Hq, D), (B, Sk, Hk, D),
                               (B, Sk, Hk, D)))
