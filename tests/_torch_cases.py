"""Geometry grids shared by the port's CPU parity tests."""
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
