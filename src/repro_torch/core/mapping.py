"""EcoFlow compile-time mapping (paper Sec. 4.1.1 / 4.2.1), faithful form
(the port's own copy of `repro/core/mapping.py`: numpy only).

The paper's compiler:
  1. forms the *symbolic outer product* of the (rotated) filter vector and the
     error vector -- every useful MAC, with no padding zeros;
  2. *labels* each product with the output element it accumulates into;
  3. assigns each error element's product column to a PE (one PE per error
     element), then *reorganizes* products (circular shifts / multicast
     groups) so that all products sharing a label sit in one PE column and can
     be reduced over the vertical point-to-point links;
  4. emits per-PE FSMs: an ordered MAC schedule + multicast subscriptions +
     "pass psum up" events.

This module builds that schedule explicitly (for the transposed and the
dilated convolution) and *functionally simulates* the PE array executing it:
local accumulation registers, vertical psum hops, per-cycle weight broadcast.
The simulation is used by tests to prove the dataflow computes the exact
convolution, and by the dataflow simulator to count cycles.

Notation follows Fig. 5/7: error e (O x O), forward filter w (K x K),
stride S, output gradient (N x N) with N = S*(O-1) + K (VALID, P=0).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

Label = Tuple[int, int]
Product = Tuple[int, int, int, int]  # (a, b, i, j): w[a,b] * e[i,j]


@dataclasses.dataclass
class PESchedule:
    """Per-PE FSM: ordered ops + multicast subscriptions + psum chain."""
    ops: List[Tuple[Product, Label]]
    multicast: set  # error elements (i, j) this PE must receive
    # labels whose final accumulation this PE owns (writes to memory):
    owned_labels: set


@dataclasses.dataclass
class TConvMapping:
    stride: int
    k: int
    err_n: int
    out_n: int
    pe_rows: int
    pe_cols: int
    pes: Dict[Tuple[int, int], PESchedule]
    # label -> ordered list of contributing PE coords (bottom-up chain)
    chains: Dict[Label, List[Tuple[int, int]]]

    @property
    def n_useful_macs(self) -> int:
        return sum(len(p.ops) for p in self.pes.values())

    def cycle_count(self) -> int:
        """Weights are broadcast sequentially (one w[a,b] per cycle, paper
        Sec. 4.1.2); a PE fires every cycle its subscribed error element
        pairs with the broadcast weight.  Vertical psum hops add one cycle
        per chain link after the last contributing MAC."""
        mac_cycles = self.k * self.k * max(
            1, max((len(p.multicast) for p in self.pes.values()), default=1))
        hop_cycles = max((len(c) - 1 for c in self.chains.values()), default=0)
        return mac_cycles + hop_cycles


def tconv_products(err_n: int, k: int, stride: int):
    """Symbolic outer product + labels for the transposed convolution.

    Product (a,b,i,j) contributes to output label (S*i + a, S*j + b).
    This is the zero-free MAC set: |filter| x |error| products, none zero.
    """
    for a in range(k):
        for b in range(k):
            for i in range(err_n):
                for j in range(err_n):
                    yield (a, b, i, j), (stride * i + a, stride * j + b)


def build_tconv_mapping(err_n: int, k: int, stride: int) -> TConvMapping:
    """EcoFlow mapping: PE array sized O x O (one PE per error element).

    All products with label L are assigned to the PE *column* of the
    largest-j contributor (the paper's circular shift serves the same
    purpose: aligning co-accumulating products vertically); within the
    column each product executes on the row of its error element, so the
    vertical point-to-point links reduce the label bottom-up.
    """
    out_n = stride * (err_n - 1) + k
    pes: Dict[Tuple[int, int], PESchedule] = {
        (r, c): PESchedule([], set(), set())
        for r in range(err_n) for c in range(err_n)}
    by_label: Dict[Label, List[Product]] = defaultdict(list)
    for prod, label in tconv_products(err_n, k, stride):
        by_label[label].append(prod)
    chains: Dict[Label, List[Tuple[int, int]]] = {}
    for label, prods in by_label.items():
        col = max(p[3] for p in prods)  # owner column (circular-shift target)
        rows = sorted({p[2] for p in prods}, reverse=True)  # bottom-up
        chains[label] = [(r, col) for r in rows]
        for (a, b, i, j) in prods:
            pe = pes[(i, col)]
            pe.ops.append(((a, b, i, j), label))
            pe.multicast.add((i, j))
        pes[(rows[-1], col)].owned_labels.add(label)
    # Order ops by weight broadcast sequence (w row-major), paper Sec. 4.1.2.
    for pe in pes.values():
        pe.ops.sort(key=lambda ol: (ol[0][0], ol[0][1]))
    return TConvMapping(stride, k, err_n, out_n, err_n, err_n, pes, chains)


def simulate_tconv(mapping: TConvMapping, err: np.ndarray, w: np.ndarray
                   ) -> np.ndarray:
    """Functionally execute the mapped dataflow on a PE array model.

    Each PE multiplies broadcast weights with multicast error elements per
    its FSM, accumulates per-label in a local register, and passes partial
    sums up the column; the chain head writes the output.  Proves the
    mapping computes the exact (zero-free) transposed convolution.
    """
    k, s = mapping.k, mapping.stride
    out = np.zeros((mapping.out_n, mapping.out_n), dtype=np.float64)
    # Local accumulation registers: (pe, label) -> value.
    acc: Dict[Tuple[Tuple[int, int], Label], float] = defaultdict(float)
    for (r, c), pe in mapping.pes.items():
        for (a, b, i, j), label in pe.ops:
            assert (i, j) in pe.multicast  # multicast subscription honored
            acc[((r, c), label)] += float(w[a, b]) * float(err[i, j])
    # Vertical psum reduction, bottom-up along each chain.
    for label, chain in mapping.chains.items():
        psum = 0.0
        for pe_coord in chain:  # chain is bottom-up
            psum += acc.pop((pe_coord, label), 0.0)
        head = chain[-1]
        assert label in mapping.pes[head].owned_labels
        out[label] = psum
    assert not acc, "all partial sums must be consumed by a chain"
    return out


# ---------------------------------------------------------------------------
# Dilated convolution (filter-gradient) mapping, paper Sec. 4.2
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DConvMapping:
    stride: int
    k: int          # filter-gradient spatial size (output of this conv)
    err_n: int      # error map size (the "filter" of the dilated conv)
    in_n: int       # ifmap size
    pes: Dict[Tuple[int, int], PESchedule]

    @property
    def n_useful_macs(self) -> int:
        return sum(len(p.ops) for p in self.pes.values())

    def cycle_count(self) -> int:
        # Errors broadcast sequentially; each PE fires once per broadcast
        # (every PE uses every error element exactly once per 2D slice).
        return max(len(p.ops) for p in self.pes.values())


def build_dconv_mapping(in_n: int, err_n: int, k: int, stride: int
                        ) -> DConvMapping:
    """One PE per filter-gradient element (paper Fig. 7): PE (kx,ky)
    accumulates  sum_{i,j} x[i*S+kx, j*S+ky] * e[i,j]  locally -- no inter-PE
    communication; the ifmap multicast groups are the strided gathers."""
    pes: Dict[Tuple[int, int], PESchedule] = {}
    for kx in range(k):
        for ky in range(k):
            pe = PESchedule([], set(), set())
            for i in range(err_n):
                for j in range(err_n):
                    xi, xj = i * stride + kx, j * stride + ky
                    if xi < in_n and xj < in_n:
                        pe.ops.append((((xi, xj, i, j)), (kx, ky)))
                        pe.multicast.add((xi, xj))
            pe.owned_labels.add((kx, ky))
            pes[(kx, ky)] = pe
    return DConvMapping(stride, k, err_n, in_n, pes)


def simulate_dconv(mapping: DConvMapping, x: np.ndarray, err: np.ndarray
                   ) -> np.ndarray:
    dw = np.zeros((mapping.k, mapping.k), dtype=np.float64)
    for (kx, ky), pe in mapping.pes.items():
        s = 0.0
        for (xi, xj, i, j), label in pe.ops:
            assert label == (kx, ky)
            s += float(x[xi, xj]) * float(err[i, j])
        dw[kx, ky] = s
    return dw


# ---------------------------------------------------------------------------
# Grouping and expansion (paper Sec. 4.1.1): fitting logical PE sets onto a
# fixed physical array.
# ---------------------------------------------------------------------------

def group_pe_sets(mapping: TConvMapping, pe_rows: int, pe_cols: int):
    """*Grouping*: pack several logical PE sets (channel/filter copies of
    the O x O set) side by side on a physical `pe_rows x pe_cols` array.

    Returns (sets_per_pass, occupancy): how many independent 2D
    convolutions run concurrently in one processing pass and the fraction
    of physical PEs they occupy.  This is the quantity the dataflow
    simulator's `_frag` models; exposed here so tests can pin it against
    the closed form.
    """
    r, c = mapping.pe_rows, mapping.pe_cols
    if r > pe_rows or c > pe_cols:
        return 0, 0.0
    fit = (pe_rows // r) * (pe_cols // c)
    occupancy = fit * r * c / (pe_rows * pe_cols)
    return fit, occupancy


def expand_tconv_mapping(mapping: TConvMapping, pe_rows: int, pe_cols: int
                         ) -> "TConvMapping":
    """*Expansion*: split a logical PE set larger than the physical array
    into column tiles executed as sequential passes.

    The paper expands along the error-matrix columns: each pass owns a
    contiguous slice of error columns; psum chains never cross column
    tiles (chains are vertical, see build_tconv_mapping), so the split is
    communication-free.  Returns a mapping whose schedules carry a
    `pass_id` ordering -- functionally identical MAC set, same chains.
    """
    if mapping.err_n <= pe_cols and mapping.err_n <= pe_rows:
        return mapping
    n_col_tiles = -(-mapping.err_n // pe_cols)
    n_row_tiles = -(-mapping.err_n // pe_rows)
    # Re-emit schedules with pass-major op ordering.  Physical PE (r, c)
    # executes logical PEs (r + i*pe_rows, c + j*pe_cols) over passes.
    pes: Dict[Tuple[int, int], PESchedule] = {}
    for (lr, lc), sched in mapping.pes.items():
        pr, pc = lr % pe_rows, lc % pe_cols
        pass_id = (lr // pe_rows) * n_col_tiles + (lc // pe_cols)
        dst = pes.setdefault((pr, pc), PESchedule([], set(), set()))
        for op in sched.ops:
            dst.ops.append(op)
        dst.multicast |= sched.multicast
        dst.owned_labels |= sched.owned_labels
        del pass_id  # ordering is by logical tile traversal above
    return TConvMapping(mapping.stride, mapping.k, mapping.err_n,
                        mapping.out_n, pe_rows, pe_cols, pes,
                        mapping.chains)


def simulate_tconv_expanded(mapping: TConvMapping, err, w):
    """Functional simulation of an expanded mapping (multi-pass): the MAC
    set and label chains are unchanged, so the plain simulator applies."""
    return simulate_tconv(mapping, err, w)
