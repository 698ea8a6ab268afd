"""The dry-run and its models against `repro`'s: `benchmarks/flops.py` and
`benchmarks/roofline.py` (with `repro`'s own hardware constants passed
in), the cell list of `--all`, the argument bytes of `repro`'s miniature
dry-run cells against XLA's `memory_analysis()`, and the attention
kernels' fake forms.

The fake world and `repro`'s forced host devices are process-global, so
each side runs its miniature cells in one subprocess of its own (the two
run at once)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import flops as RF
from benchmarks import roofline as RR
from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.configs import supported_shapes as r_supported_shapes
from repro.models.config import SHAPES as R_SHAPES
from repro_torch.benchmarks import flops as F
from repro_torch.benchmarks import roofline as R
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 supported_shapes)
from repro_torch.kernels import attention, build, ops
from repro_torch.launch import dryrun, steps
from repro_torch.models.config import SHAPES, ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
REPRO_HW = F.Hardware("repro", RF.PEAK_FLOPS, RF.HBM_BW, RF.LINK_BW)
CELLS = [(a, s) for a in ARCH_IDS for s in supported_shapes(get_config(a))]
MODES = (None, "train", "serve", "serve_opt")

# `repro`'s miniature dry-run cells (tests/test_multidevice.py: the SMOKE
# qwen3-moe-235b-a22b on a (4, 2) mesh, train and decode at seq 64,
# batch 8; gemma-7b with attn_chunk 32 on (2, 4), decode) and a prefill.
MINI = {"moe_train": ("qwen3_moe_235b_a22b", (4, 2), "train", {}),
        "moe_decode": ("qwen3_moe_235b_a22b", (4, 2), "decode", {}),
        "moe_prefill": ("qwen3_moe_235b_a22b", (4, 2), "prefill", {}),
        "gemma_decode": ("gemma_7b", (2, 4), "decode", {"attn_chunk": 32})}
MINI_SEQ, MINI_BATCH = 64, 8
# What XLA's arguments hold that the port's do not: a decode cell's cache
# "len" is an int32 scalar in `repro`, a Python int in the port.
XLA_ONLY_ARGUMENT_BYTES = {"train": 0, "prefill": 0, "decode": 4}

_PORT = """
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import lower_cell
from repro_torch.models.config import ShapeConfig
MINI = json.loads(sys.argv[1])
dryrun.fake_world(8)
out = {}
for name, (arch, mesh_shape, kind, kw) in MINI.items():
    mesh = make_debug_mesh(tuple(mesh_shape), ("data", "model"),
                           device="cpu")
    cfg = get_smoke_config(arch).scaled(**kw)
    cell = lower_cell(cfg, ShapeConfig("mini_" + kind, %d, %d, kind), mesh)
    out[name] = cell.trace()
sys.argv = ["dryrun", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
            "--out", sys.argv[2]]
dryrun.main()
print(json.dumps(out))
""" % (MINI_SEQ, MINI_BATCH)

_REPRO = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.launch.steps import lower_cell
from repro.models.config import ShapeConfig
MINI = json.loads(sys.argv[1])
out = {}
for name, (arch, mesh_shape, kind, kw) in MINI.items():
    mesh = Mesh(np.asarray(jax.devices()).reshape(*mesh_shape),
                ("data", "model"))
    cfg = get_smoke_config(arch).scaled(**kw)
    ma = lower_cell(cfg, ShapeConfig("mini_" + kind, %d, %d, kind),
                    mesh).compile().memory_analysis()
    out[name] = ma.argument_size_in_bytes
print(json.dumps(out))
""" % (MINI_SEQ, MINI_BATCH)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """({cell: the port's trace}, {cell: XLA's argument bytes}, the
    production cell's record the CLI wrote)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                               json.dumps(MINI), str(out)], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for code in (_PORT, _REPRO)]
    results = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    rec = json.loads((out / "qwen3-0.6b.decode_32k.16x16.json").read_text())
    return results[0], results[1], rec


# ---------------------------------------------------------------------------
# benchmarks/flops.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_equal_repro(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert F.params_per_layer(cfg) == RF.params_per_layer(rcfg)
    assert F.total_params(cfg) == RF.total_params(rcfg)
    assert F.active_params(cfg) == RF.active_params(rcfg)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_cost_equals_repro_in_every_mode(arch, shape):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for mode in MODES:
        for precast in (False, True):
            for kv_quant in (False, True):
                kw = dict(mode=mode, precast=precast, kv_quant=kv_quant)
                got = F.cell_cost(cfg, SHAPES[shape], **kw)
                want = RF.cell_cost(rcfg, R_SHAPES[shape], **kw)
                assert got.__dict__ == want.__dict__, (mode, precast,
                                                       kv_quant)


def test_hardware_default_is_the_h100():
    assert F.H100_SXM.peak_flops == 989e12
    assert F.H100_SXM.hbm_bw == 3.35e12
    assert (F.DATA_AX, F.MODEL_AX, F.CHIPS) == (RF.DATA_AX, RF.MODEL_AX,
                                                RF.CHIPS)


# ---------------------------------------------------------------------------
# benchmarks/roofline.py
# ---------------------------------------------------------------------------

def _record(arch, shape):
    return {"arch": arch, "shape": shape, "compile_s": 12.5,
            "temp_size_in_bytes": 3 * 2**30 + 17,
            "cost": {"flops": 1.25e15},
            "collectives": {"all-gather": {"count": 7, "bytes": 99},
                            "all-reduce": {"count": 3, "bytes": 12},
                            "reduce-scatter": {"count": 0, "bytes": 0},
                            "group_sizes": [16]}}


@pytest.mark.parametrize("with_record", [False, True])
def test_cell_roofline_equals_repro(with_record, tmp_path, monkeypatch):
    monkeypatch.setattr(R, "RESULTS", str(tmp_path))
    monkeypatch.setattr(RR, "RESULTS", str(tmp_path))
    for arch, shape in CELLS:
        if with_record:
            (tmp_path / f"{arch}.{shape}.16x16.json").write_text(
                json.dumps(_record(arch, shape)))
        got = R.cell_roofline(arch, shape, REPRO_HW)
        assert got == RR.cell_roofline(arch, shape), (arch, shape)
        assert ("hlo_flops" in got) == with_record
    assert R.bench_rows(REPRO_HW) == RR.bench_rows()


def test_roofline_reads_its_own_directory():
    assert Path(R.RESULTS) == ROOT / "dryrun_out"
    assert Path(R.RESULTS) != Path(RR.RESULTS)


# ---------------------------------------------------------------------------
# launch/dryrun.py: the cell list, the CLI, the miniature cells
# ---------------------------------------------------------------------------

def test_all_cells_equal_repro():
    want = []
    for arch in R_ARCH_IDS:         # repro/launch/dryrun.py::main's loop
        for s in r_supported_shapes(r_get_config(arch)):
            want.append((arch, s, False))
            want.append((arch, s, True))
    assert dryrun.cells(all_cells=True) == want
    assert dryrun.cells("gemma_2b", "train_4k", True) == [
        ("gemma_2b", "train_4k", True)]


@pytest.mark.parametrize("argv", [["--arch", "gemma-2b", "--shape",
                                   "train_4k", "--save-hlo"], []])
def test_cli_refuses_save_hlo_and_a_missing_cell(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["dryrun"] + argv)
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 2
    assert ("--save-hlo" if argv else "--all") in capsys.readouterr().err


@pytest.mark.parametrize("name", list(MINI))
def test_argument_bytes_equal_xla(mini, name):
    port, xla, _ = mini
    kind = MINI[name][2]
    assert port[name]["argument_size_in_bytes"] + \
        XLA_ONLY_ARGUMENT_BYTES[kind] == xla[name]


def test_mini_moe_cells_mirror_repro(mini):
    """`test_mini_dryrun_lower_compile`: temp bytes and collectives."""
    port = mini[0]
    for name in ("moe_train", "moe_decode"):
        rec = port[name]
        assert rec["temp_size_in_bytes"] > 0
        total = sum(v["count"] for k, v in rec["collectives"].items()
                    if k != "group_sizes")
        assert total > 0, rec["collectives"]
        assert rec["collectives"]["reduce-scatter"]["count"] == 0
    train = port["moe_train"]
    assert train["alias_size_in_bytes"] == 0      # AdamW is out of place
    # the card's path: every attention call on a fake form, counted as
    # the launch the card would make (and no real launch)
    assert train["launches"] == {"flash_attention": 8,
                                 "flash_attention_backward": 4}
    assert train["attention_forms"] == {"forward": {"tile": 8},
                                        "backward": {"simt": 4}}
    assert set(port["moe_decode"]["attention_forms"]["forward"]) == {
        "split"}


def test_mini_gemma_decode_gathers_less_than_the_cache(mini):
    """`test_decode_lowering_has_no_cache_gather`, and the decode writes
    the cache in place."""
    rec = mini[0]["gemma_decode"]
    cfg = get_smoke_config("gemma_7b")
    cache = cfg.n_layers * MINI_BATCH * MINI_SEQ * cfg.n_kv_heads * \
        cfg.head_dim * 2 * 2
    assert rec["collectives"]["all-gather"]["bytes"] < cache
    # rank 0's block of the bf16 k and v: batch over 2, sequence over 4
    assert rec["alias_size_in_bytes"] == cache // 8


@pytest.mark.parametrize("name", list(MINI))
def test_traced_flops_reach_the_model(mini, name):
    """`repro`'s impl_flops >= 0.9 * model_flops, per rank times ranks."""
    arch, mesh_shape, kind, kw = MINI[name]
    cfg = get_smoke_config(arch).scaled(**kw)
    model = F.cell_cost(cfg, ShapeConfig("mini", MINI_SEQ, MINI_BATCH,
                                         kind)).model_flops
    ranks = int(np.prod(mesh_shape))
    assert mini[0][name]["cost"]["flops"] * ranks >= 0.9 * model


def test_cli_writes_a_production_record(mini):
    rec = mini[2]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"]) == (
        "qwen3-0.6b", "decode_32k", "16x16", 256)
    cfg = get_config("qwen3-0.6b")
    B, S = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    cache = cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    assert rec["alias_size_in_bytes"] == cache // 256
    assert rec["argument_size_in_bytes"] > cache // 256
    assert rec["launches"] == {"flash_attention": cfg.n_layers}
    assert rec["attention_forms"]["forward"] == {"split": cfg.n_layers}
    assert "hlo_bytes" not in rec
    assert set(rec["collectives"]) == {*steps.COLLECTIVES, "group_sizes"}


# ---------------------------------------------------------------------------
# The attention kernels' fake forms
# ---------------------------------------------------------------------------

# (dtype, B, Sq, Sk, Hq, Hk, D, q_offset or None, return_lse)
FORM_CASES = [
    (torch.float32, 2, 40, 40, 4, 4, 64, None, False),     # tile
    (torch.bfloat16, 1, 70, 70, 8, 2, 128, None, True),    # wgmma, GQA
    (torch.bfloat16, 2, 1, 300, 8, 2, 64, 299, False),     # split decode
    (torch.float32, 1, 3, 90, 6, 3, 32, 50, True),         # q_offset
]


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernels.build was called")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "kernel_function", refuse)
    ops.reset_launches()
    yield
    ops.reset_launches()


def _qkv(dtype, B, Sq, Sk, Hq, Hk, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shp, generator=g).to(dtype)
            for shp in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D))]


def _like(fake, real):
    """Shape, dtype and the kernels' dense strides: the plain lse can be a
    permuted view of its statistics, the kernel writes it contiguous."""
    return (fake.shape, fake.dtype, fake.stride()) == (
        real.shape, real.dtype, real.contiguous().stride())


@pytest.mark.parametrize("case", FORM_CASES, ids=str)
def test_fake_forward_matches_the_plain_version(case, no_build):
    from torch._subclasses.fake_tensor import FakeTensorMode
    dtype, B, Sq, Sk, Hq, Hk, D, off, lse = case
    q, k, v = _qkv(dtype, B, Sq, Sk, Hq, Hk, D)
    want = ops.flash_attention(q, k, v, q_offset=off, return_lse=lse)
    assert attention.FAKE_CALLS["flash_attention"] == 0  # real CPU: plain
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        got = ops.flash_attention(fq, fk, fv, q_offset=off, return_lse=lse)
    got, want = (tuple(t) if lse else (t,) for t in (got, want))
    assert all(_like(a, b) for a, b in zip(got, want))
    form = attention.plan(dtype, B, Sq, Sk, Hq, Hk, D)
    assert attention.FAKE_CALLS["flash_attention"] == 1
    assert attention.FAKE_FORMS["forward"] == {
        f: int(f == form.form) for f in attention.FORMS}
    assert not any(ops.LAUNCHES.values())       # a fake form launches none
    assert not any(ops.FLASH_FORMS.values())
    off = Sk - Sq if off is None else off
    assert attention.FAKE_FLOPS["flash_attention"] == \
        4 * D * B * Hq * attention.visible_pairs(Sq, Sk, True, off)


@pytest.mark.parametrize("case", FORM_CASES[:2] + FORM_CASES[3:], ids=str)
def test_fake_backward_through_autograd(case, no_build):
    """FlashAttentionFn on fake tensors: one forward with its lse and one
    backward, each counted in its form; the gradients shaped as the
    plain version's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dtype, B, Sq, Sk, Hq, Hk, D, off, _ = case
    q, k, v = (t.requires_grad_() for t in _qkv(dtype, B, Sq, Sk, Hq, Hk, D))
    want = torch.autograd.grad(
        ops.flash_attention(q, k, v, q_offset=off).float().sum(), (q, k, v))
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t).requires_grad_()
                      for t in (q, k, v))
        got = torch.autograd.grad(
            ops.flash_attention(fq, fk, fv, q_offset=off).float().sum(),
            (fq, fk, fv))
    assert all(_like(a, b) for a, b in zip(got, want))
    assert attention.FAKE_CALLS == {"flash_attention": 1,
                                    "flash_attention_backward": 1}
    form = attention.backward_plan(dtype, B, Sq, Sk, Hq, Hk, D)
    assert attention.FAKE_FORMS["backward"] == {
        f: int(f == form) for f in attention.BWD_FORMS}
    assert not any(ops.LAUNCHES.values())
    assert not any(ops.FLASH_BWD_FORMS.values())
    off = Sk - Sq if off is None else off
    assert attention.FAKE_FLOPS["flash_attention_backward"] == \
        10 * D * B * Hq * attention.visible_pairs(Sq, Sk, True, off)


def test_fake_forms_allocate_as_a_launch_does(no_build):
    """The forward's output and lse, the backward's delta and gradients:
    every byte the launches allocate, nothing more."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import TraceCounters
    B, S, H, D = 1, 64, 4, 64
    with FakeTensorMode() as mode:
        q, k, v, out, dout = (mode.from_tensor(torch.zeros(B, S, H, D))
                              for _ in range(5))
        lse = mode.from_tensor(torch.zeros(B, H, S))
        counters = TraceCounters()
        with counters:
            o, l = attention.flash_attention_cuda(
                q, k, v, causal=True, q_offset=0,
                form=attention.AttentionPlan("tile", 1), return_lse=True)
            grads = attention.flash_attention_backward_cuda(
                q, k, v, out, dout, lse, causal=True, q_offset=0,
                form="simt")
    nbytes = 4 * (B * S * H * D + B * H * S)
    assert counters.peak == nbytes + 4 * (B * H * S + 3 * B * S * H * D)
    assert o.shape == (B, S, H, D) and l.shape == (B, H, S)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_summary_tabulates_the_records(mini, tmp_path):
    rec = mini[2]
    (tmp_path / "qwen3_0_6b.decode_32k.16x16.json").write_text(
        json.dumps(rec))
    rows = dryrun.summary(str(tmp_path))
    assert len(rows) == 1
    cells = [c.strip() for c in rows[0].strip("|").split("|")]
    assert cells[:3] == ["qwen3_0_6b", "decode_32k", "16x16"]
    assert float(cells[3]) == round(rec["peak_size_in_bytes"] / 1e9, 2)
    assert cells[4] == "yes" and int(cells[8]) == 28


def test_trace_counters_count_no_meta_tensor():
    """A meta tensor (the LM's cache specs are made on it inside a step)
    allocates nothing on any device; a fake one counts its bytes until it
    is freed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    counters = steps.TraceCounters()
    with FakeTensorMode(), counters:
        torch.zeros((1 << 20, 1024), device="meta")
        t = torch.empty((256, 1024), dtype=torch.bfloat16)
        assert counters.live == 256 * 1024 * 2
        del t
    assert counters.live == 0 and counters.peak == 256 * 1024 * 2
