"""SASiML-lite: analytical cycle + energy model for spatial-array dataflows
(the port's own copy of `repro/core/dataflow_sim.py`: plain Python).

The paper evaluates EcoFlow in SASiML, a cycle-accurate simulator of an
Eyeriss-class spatial array (13 x 15 PEs, 200 MHz, Table 3) with three
dataflow models: Row-Stationary (Eyeriss), TPU-style lowering (im2col +
output-stationary matmul), and EcoFlow.  We re-scope SASiML as an
*analytical* model: MAC schedules and memory-hierarchy access counts are
derived in closed form from the layer geometry and dataflow, energies from
Horowitz-45nm-class constants.  The functional correctness of the EcoFlow
schedule itself is proven separately (`repro_torch.core.mapping` simulates
the PE array op-by-op).

The model reproduces the paper's *ratios*: Fig. 3 zero-MAC fractions,
Fig. 8/9 input/filter-gradient speedups (~4x @ stride 2, ~11x @ stride 4,
~52x @ stride 8 vs the TPU dataflow), Table 6/8 end-to-end gains, and the
Fig. 10/12 energy-breakdown shape (savings concentrated in SPAD + NoC,
DRAM roughly maintained).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal

from repro_torch.core import ecoflow
from repro_torch.core.spec import ConvSpec

Op = Literal["forward", "input_grad", "filter_grad", "dilated_forward"]
Dataflow = Literal["rs", "tpu", "ecoflow"]


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Paper Table 3 accelerator configuration."""
    pe_rows: int = 13
    pe_cols: int = 15
    clock_hz: float = 200e6
    word_bits: int = 16
    # Energy constants (pJ), Horowitz ISSCC'14 45nm class, 16-bit datapath.
    e_mac: float = 1.0          # 16b multiply + add
    e_spad: float = 1.0         # PE register-file access (per word)
    e_noc: float = 2.0          # on-chip network transfer (per word)
    e_gbuf: float = 20.0        # 108KB global buffer access (per word)
    e_dram: float = 320.0       # DRAM access (per 16-bit word), DDR4-class

    @property
    def n_pes(self) -> int:
        return self.pe_rows * self.pe_cols


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer (square spatial dims, as in the paper)."""
    name: str
    c_in: int       # input channels
    n_in: int       # ifmap spatial size
    n_out: int      # ofmap spatial size
    k: int          # filter spatial size
    m: int          # number of filters (output channels)
    stride: int
    batch: int = 4  # paper uses batch 4
    dilation: int = 1  # forward filter dilation (atrous rate)

    @property
    def k_eff(self) -> int:
        """Effective receptive field D*(K-1)+1 of the dilated filter."""
        return self.dilation * (self.k - 1) + 1

    @property
    def padding(self) -> int:
        # Padding consistent with n_out = (n_in + 2P - K_eff)/S + 1.
        return max(0, ((self.n_out - 1) * self.stride + self.k_eff
                       - self.n_in + 1) // 2)


# --------------------------------------------------------------------------
# MAC counting
# --------------------------------------------------------------------------

def useful_macs(layer: ConvLayer, op: Op) -> int:
    """Zero-free MAC count.  Every forward MAC has exactly one input-grad MAC
    and one filter-grad MAC, so all three ops share the same useful count."""
    return (layer.batch * layer.m * layer.c_in *
            layer.n_out ** 2 * layer.k ** 2)


def scheduled_macs(layer: ConvLayer, op: Op, dataflow: Dataflow) -> int:
    """MACs the dataflow actually schedules (incl. multiplications by
    padding zeros for the naive dataflows -- the PEs spend the cycles even if
    the multiplier is clock-gated, paper Sec. 3.1)."""
    if dataflow == "ecoflow":
        return useful_macs(layer, op)
    if op == "dilated_forward":
        # Naive dataflows sweep the filter at its materialized effective
        # extent: K_eff^2 MACs per output position, K^2 of them useful.
        return (layer.batch * layer.m * layer.c_in *
                layer.n_out ** 2 * layer.k_eff ** 2)
    if op == "forward" or layer.stride == 1:
        # Stride 1 inserts no dilation zeros, so EVERY dataflow schedules
        # exactly the useful MACs (zero_mac_fraction == 0) -- previously
        # the stride==1 case for tpu/rs gradient ops fell through to the
        # padded-MAC formulas below.
        return useful_macs(layer, op)
    s, k, n_err = layer.stride, layer.k, layer.n_out
    if op == "input_grad":
        # Direct conv over the zero-dilated + border-padded error map:
        # n_in^2 output positions, k^2 MACs each.
        return layer.batch * layer.m * layer.c_in * layer.n_in ** 2 * k ** 2
    elif op == "filter_grad":
        # Direct conv of the ifmap with the zero-dilated error as filter:
        # k^2 output positions, dil^2 MACs each.
        dil = s * (n_err - 1) + 1
        return layer.batch * layer.m * layer.c_in * k ** 2 * dil ** 2
    return useful_macs(layer, op)


def zero_mac_fraction(layer: ConvLayer, op: Op) -> float:
    tot = scheduled_macs(layer, op, "tpu")
    return 1.0 - useful_macs(layer, op) / tot


def predicated_lane_fraction(layer: ConvLayer) -> float:
    """Masked-lane fraction of the implicit-GEMM input-gradient lowering
    of this layer -- the flat `(B*Fh*Fw) x (K^2*M)` GEMM with an in-bound
    predicate per lane (kernels/implicit_gemm.py).  Delegates to the same
    `ecoflow.predicated_mac_fraction` closed form the strategy planner's
    waste term uses (`kernels/tiling.py`), so the simulator's lane
    accounting and the planner's race cannot drift apart.  Zero at
    stride 1 / dilation 1, where the GEMM degenerates to the dense
    correlation and every lane is useful."""
    spec = ConvSpec.make(stride=layer.stride, padding=layer.padding,
                         filter_shape=layer.k, dilation=layer.dilation)
    return ecoflow.predicated_mac_fraction(
        spec, (layer.n_out, layer.n_out))


# --------------------------------------------------------------------------
# Cycle model
# --------------------------------------------------------------------------

def _frag(n: int, d: int) -> float:
    """Array-dimension fragmentation with tile packing: when a tile dim is
    smaller than the array dim, the compiler packs independent tiles side by
    side (paper: grouping); the final partial tile still wastes lanes."""
    if n >= d:
        return n / (math.ceil(n / d) * d)
    return (n * (d // n)) / d


def _mapping_utilization(layer: ConvLayer, op: Op, dataflow: Dataflow,
                         hw: ArrayConfig) -> float:
    """Fraction of PE-cycles doing scheduled work (edge/fragmentation
    effects of fitting the tiling onto the fixed array)."""
    R, C = hw.pe_rows, hw.pe_cols
    if dataflow == "tpu":
        # Lowered matmul, output-stationary systolic tiles of R x C outputs;
        # edge waste from partial tiles + pipeline fill of the contraction.
        if op == "forward":
            rows, cols = layer.batch * layer.n_out ** 2, layer.m
            depth = layer.k ** 2 * layer.c_in
        elif op == "dilated_forward":
            # im2col over the materialized K_eff-extent filter.
            rows, cols = layer.batch * layer.n_out ** 2, layer.m
            depth = layer.k_eff ** 2 * layer.c_in
        elif op == "input_grad":
            # (B*Nin^2, K^2*M) @ (K^2*M, Cin) over the padded error map.
            rows, cols = layer.batch * layer.n_in ** 2, layer.c_in
            depth = layer.k ** 2 * layer.m
        else:  # filter_grad: (K^2*Cin, B*Odil^2) @ (.., M)
            rows, cols = layer.k ** 2 * layer.c_in, layer.m
            depth = layer.batch * (layer.stride * (layer.n_out - 1) + 1) ** 2
        fill = depth / (depth + R)  # systolic fill/drain overhead
        return _frag(rows, R) * _frag(cols, C) * fill
    if dataflow == "rs":
        # Row-stationary: PE sets of (filter rows x output rows).
        if op == "input_grad":
            set_h, set_w = layer.k, min(layer.n_in, C)
        elif op == "filter_grad":
            set_h, set_w = min(layer.stride * (layer.n_out - 1) + 1, R), layer.k
        elif op == "dilated_forward":
            # Filter rows at the materialized K_eff extent.
            set_h, set_w = min(layer.k_eff, R), min(layer.n_out, C)
        else:
            set_h, set_w = layer.k, min(layer.n_out, C)
        used = min(hw.n_pes,
                   max(1, R // max(1, set_h)) * max(1, C // max(1, set_w)) *
                   set_h * set_w)
        return used / hw.n_pes
    # EcoFlow.  Input grads: PE sets sized by the error matrix (one PE per
    # error element, K^2 MACs each -- perfectly balanced by the circular
    # shift); expansion splits sets larger than the array, grouping packs
    # small ones (paper Sec. 4.1.1).  Residual waste: the final partial
    # expansion slice + the vertical psum-hop cycles at the end of each
    # label chain (ceil(K/S)-1 hops per K^2-MAC schedule).
    if op == "filter_grad":
        # One PE per filter-gradient element; channels/filters grouped, so
        # the array is saturated whenever K^2*Cin*M >= n_pes.
        sets = layer.k ** 2 * layer.c_in * layer.m
        occupancy = _frag(sets, hw.n_pes) if sets >= hw.n_pes else sets / hw.n_pes
        return occupancy
    # input_grad / forward / dilated_forward: one PE per output (error)
    # element, K^2 useful MACs each.  For the dilated forward the psum
    # chain spans the D-spaced tap extent instead of the stride-phase
    # extent -- the same ceil(extent/stride)-1 hop model with K_eff.
    err2 = layer.n_out ** 2
    occupancy = _frag(err2 * layer.batch * layer.m, hw.n_pes)
    extent = layer.k_eff if op == "dilated_forward" else layer.k
    hops = max(0, math.ceil(extent / layer.stride) - 1)
    hop_util = layer.k ** 2 / (layer.k ** 2 + hops)
    return occupancy * hop_util


def cycles(layer: ConvLayer, op: Op, dataflow: Dataflow,
           hw: ArrayConfig = ArrayConfig()) -> float:
    util = _mapping_utilization(layer, op, dataflow, hw)
    return scheduled_macs(layer, op, dataflow) / (hw.n_pes * util)


def exec_time_s(layer: ConvLayer, op: Op, dataflow: Dataflow,
                hw: ArrayConfig = ArrayConfig()) -> float:
    return cycles(layer, op, dataflow, hw) / hw.clock_hz


def speedup(layer: ConvLayer, op: Op, dataflow: Dataflow,
            baseline: Dataflow = "tpu", hw: ArrayConfig = ArrayConfig()
            ) -> float:
    return cycles(layer, op, baseline, hw) / cycles(layer, op, dataflow, hw)


# --------------------------------------------------------------------------
# Energy model
# --------------------------------------------------------------------------

def energy_breakdown_pj(layer: ConvLayer, op: Op, dataflow: Dataflow,
                        hw: ArrayConfig = ArrayConfig()) -> Dict[str, float]:
    """Energy per component (pJ).  Baselines clock-gate zero MACs (no ALU
    energy) but still move the zeros through SPAD/NoC -- which is exactly
    where the paper observes EcoFlow's savings (Fig. 10/12)."""
    sched = scheduled_macs(layer, op, dataflow)
    useful = useful_macs(layer, op)
    B, Cin, M, K, S = layer.batch, layer.c_in, layer.m, layer.k, layer.stride

    alu = useful * hw.e_mac
    # SPAD: each scheduled MAC reads an input word + a weight word and
    # read-modify-writes a psum word (zeros still occupy schedule slots).
    spad = sched * 4 * hw.e_spad
    # NoC: every scheduled input element delivery (multicast counted once
    # per receiving PE), plus psum hops.
    noc = sched * hw.e_noc
    if dataflow == "ecoflow":
        # Multicast groups deliver only useful elements; vertical psum hops.
        noc = useful * hw.e_noc * (1.0 + 1.0 / max(1, K))
    # Global buffer: inputs read once per processing pass with reuse across
    # the m filters; psums spilled once per pass.
    in_elems = B * Cin * layer.n_in ** 2
    err_elems = B * M * layer.n_out ** 2
    out_elems = {"forward": err_elems, "dilated_forward": err_elems,
                 "input_grad": in_elems,
                 "filter_grad": K * K * Cin * M}[op]
    reuse_passes = max(1, M // 16)
    gbuf = (in_elems * reuse_passes + err_elems * reuse_passes +
            2 * out_elems) * hw.e_gbuf
    if dataflow != "ecoflow" and sched > useful:
        # Naive dataflows stage the zero-padded tensors (stride-dilated
        # error maps / K_eff-extent filters) in the buffer.
        pad_ratio = sched / useful
        gbuf *= math.sqrt(pad_ratio)
    # DRAM: unique tensor traffic -- identical across dataflows (paper:
    # "the energy consumed by DRAM is maintained").
    dram = (in_elems + err_elems + out_elems + K * K * Cin * M) * hw.e_dram
    return {"ALU": alu, "SPAD": spad, "NoC": noc, "GBUFF": gbuf, "DRAM": dram}


def energy_pj(layer: ConvLayer, op: Op, dataflow: Dataflow,
              hw: ArrayConfig = ArrayConfig()) -> float:
    return sum(energy_breakdown_pj(layer, op, dataflow, hw).values())


# --------------------------------------------------------------------------
# Paper layer tables
# --------------------------------------------------------------------------

# Table 5: eight of the 72 evaluated CNN layers.
TABLE5_LAYERS = [
    ConvLayer("alexnet-CONV1",    3, 224, 55, 11, 64, 4),
    ConvLayer("alexnet-CONV2",   64, 31, 27, 5, 192, 1),
    ConvLayer("resnet50-CONV3", 128, 57, 28, 3, 128, 2),
    ConvLayer("shufflenet-CONV2", 58, 57, 28, 3, 58, 2),
    ConvLayer("shufflenet-CONV5", 232, 7, 7, 1, 232, 1),
    ConvLayer("inception-CONV3", 192, 17, 8, 3, 320, 2),
    ConvLayer("xception-CONV3",  728, 29, 14, 3, 1, 2),
    ConvLayer("mobilenet-CONV5", 512, 15, 7, 3, 1, 2),
]

# Optimized variants (Sec. 6.1.1): pooling replaced by larger stride.
OPT_LAYERS = [
    ConvLayer("alexnet-o-CONV1",  3, 224, 27, 11, 64, 8),
    ConvLayer("alexnet-o-CONV2", 64, 31, 13, 5, 192, 2),
]

# Table 7: GAN layers (CycleGAN / pix2pix).  Generator TCONV layers are
# encoded in their *equivalent direct-conv* orientation (a transposed conv
# IFM->OFM equals the input-gradient of a direct conv OFM->IFM), so the
# generator forward pass is the `input_grad` op of the layer below.
TABLE7_GAN_LAYERS = [
    ConvLayer("cyclegan-disc-CONV3", 64, 114, 56, 4, 128, 2),
    ConvLayer("cyclegan-gen-TCONV1", 128, 113, 56, 3, 256, 2),
    ConvLayer("pix2pix-disc-CONV6", 128, 130, 64, 4, 256, 2),
    ConvLayer("pix2pix-gen-TCONV4", 128, 130, 64, 4, 512, 2),
]

# Atrous (dilated-forward) segmentation layers -- the workload class the
# paper motivates in Sec. 1: DeepLab-style ASPP branches, stride 1 with
# the 3x3 filter applied at rate D in {2, 4}.
DILATED_LAYERS = [
    ConvLayer("deeplab-ASPP-d2", 256, 33, 33, 3, 256, 1, dilation=2),
    ConvLayer("deeplab-ASPP-d4", 256, 33, 33, 3, 256, 1, dilation=4),
]

# End-to-end model composition: fraction of training time spent in conv
# layers with stride>1 or stride-replaceable pooling (profiled breakdown,
# paper Sec. 6.1 methodology: Amdahl over per-layer GPU/CPU profiles).
END2END_FRACTIONS = {
    # name: (frac_bwd_strided, representative strided layer, frac stride-1)
    "alexnet":    (0.48, "alexnet-CONV1", 0.30),
    "resnet50":   (0.09, "resnet50-CONV3", 0.55),
    "shufflenet": (0.10, "shufflenet-CONV2", 0.55),
    "inception":  (0.10, "inception-CONV3", 0.55),
    "xception":   (0.13, "xception-CONV3", 0.55),
    "mobilenet":  (0.11, "mobilenet-CONV5", 0.55),
}

GAN_FRACTIONS = {
    # GANs use strides instead of pooling: most layers benefit; fraction is
    # the share of end-to-end training time in strided disc-bwd + gen-fwd
    # convs (profiled breakdown, Sec. 6.1 methodology).
    "pix2pix":  (0.37, "pix2pix-disc-CONV6"),
    "cyclegan": (0.40, "cyclegan-disc-CONV3"),
}


def layer_by_name(name: str) -> ConvLayer:
    for l in TABLE5_LAYERS + OPT_LAYERS + TABLE7_GAN_LAYERS + DILATED_LAYERS:
        if l.name == name:
            return l
    raise KeyError(name)


def end_to_end_speedup(network: str, dataflow: Dataflow,
                       hw: ArrayConfig = ArrayConfig()) -> float:
    """Amdahl combination over the profiled training-time breakdown:

      * `frac_strided` -- backward-pass convs with stride > 1 (or
        stride-replaceable pooling): accelerated by the dataflow at the
        representative layer's harmonic input/filter-grad speedup;
      * `frac_s1`      -- stride-1 backward convs: run at PARITY on every
        dataflow (stride 1 inserts no dilation zeros, so
        `scheduled_macs == useful_macs` and `zero_mac_fraction == 0` for
        all of tpu/rs/ecoflow -- the stride-1 fall-through fix);
      * the remainder (fwd convs, FC, optimizer): parity as well.

    The stride-1 term is carried explicitly (not folded silently into the
    remainder) so the profiled breakdown stays auditable against the
    fractions table.
    """
    frac_strided, rep, frac_s1 = END2END_FRACTIONS[network]
    if frac_strided < 0 or frac_s1 < 0 or frac_strided + frac_s1 > 1.0:
        raise ValueError(
            f"invalid training-time fractions for {network!r}: "
            f"strided={frac_strided}, stride-1={frac_s1}")
    layer = layer_by_name(rep)
    sp_ig = speedup(layer, "input_grad", dataflow, "tpu", hw)
    sp_fg = speedup(layer, "filter_grad", dataflow, "tpu", hw)
    sp = 2.0 / (1.0 / sp_ig + 1.0 / sp_fg)
    sp_s1 = 1.0   # stride-1 bwd: zero_mac_fraction == 0, all dataflows equal
    rest = 1.0 - frac_strided - frac_s1
    return 1.0 / (rest + frac_s1 / sp_s1 + frac_strided / sp)


def gan_end_to_end_speedup(network: str, dataflow: Dataflow,
                           hw: ArrayConfig = ArrayConfig()) -> float:
    frac, rep = GAN_FRACTIONS[network]
    layer = layer_by_name(rep)
    sp_ig = speedup(layer, "input_grad", dataflow, "tpu", hw)
    sp_fg = speedup(layer, "filter_grad", dataflow, "tpu", hw)
    sp = 2.0 / (1.0 / sp_ig + 1.0 / sp_fg)
    return 1.0 / ((1.0 - frac) + frac / sp)
