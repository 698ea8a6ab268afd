#!/usr/bin/env python3
"""One or two CTAs an SM for the attention backward's (b) launch at
head_dim 80: registers, spills and device time.

    python3 scripts/attention_bwd_occupancy.py

Needs one CUDA card and `nvcc`.  `attn_bwd_dkdv_wgmma_kernel`
(`csrc/flash_attention_bwd.cu`, form 1's dk / dv launch) asks for two
CTAs an SM only at head_dim 64 (`__launch_bounds__(..., D <= 64 ? 2 :
1)`); at 80 its dK and dV (40 fp32 a thread each) sit beside S^T, dP^T
and their hi/lo fragments.  This script copies the package's `csrc` into
`build/occupancy/<variant>/` twice -- "one", as committed, and "two",
its launch bound edited to `D <= 80 ? 2 : 1` -- builds each with
`-Xptxas=-v`, reads the registers and spill bytes `ptxas` reports for
the head_dim 80 instantiation of that kernel, and times the whole
backward (three launches) of each build through its own C entry at
zamba2-2.7b's shapes (32 heads, head_dim 80, causal, bf16): the engine's
batch 4 at S 1024 and the training microbatch of 2 at S 4096, in turns
one, two, two, one (CUDA events, `chip_smoke.DeviceTimer`).  The two
builds' gradients must be equal bit for bit.  One JSON line per build
and per shape, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BOUND = "D <= 64 ? 2 : 1"
VARIANTS = {"one": BOUND, "two": "D <= 80 ? 2 : 1"}
KERNEL = "attn_bwd_dkdv_wgmma_kernelILi80E"
# (B, S, heads) of zamba2's shared block: served prefill, training.
SHAPES = [(4, 1024, 32), (2, 4096, 32)]
D = 80


def build_variant(name: str, bound: str) -> tuple[ctypes.CDLL, dict]:
    """Build `csrc` with the (b) launch's bound set to `bound`; the
    library and what ptxas reports for the head_dim 80 (b) kernel."""
    from repro_torch.kernels import build
    dest = build.BUILD_DIR / "occupancy" / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", dest)
    src = dest / "flash_attention_bwd.cu"
    text = src.read_text()
    if text.count(BOUND) != 1:
        raise RuntimeError(f"expected one `{BOUND}` in {src}")
    src.write_text(text.replace(BOUND, bound))
    lib = dest / "libflash_attention_bwd.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}"
                           f"{done.stderr}")
    return ctypes.CDLL(str(lib)), ptxas_report(done.stdout + done.stderr)


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of the head_dim 80 (b) kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and KERNEL in line:
            block = "\n".join(lines[i:i + 6])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            return {"registers": int(regs.group(1)),
                    "spill_stores": int(spill.group(1)),
                    "spill_loads": int(spill.group(2))}
    raise RuntimeError(f"ptxas reported nothing for {KERNEL}")


def backward(lib, q, k, v, out, do, lse):
    """(dq, dk, dv) from one build's wgmma form."""
    from repro_torch.kernels.attention import _BWD_ARGTYPES, BWD_FORMS
    B, S, H, _ = q.shape
    fn = lib.flash_attention_bwd_bf16
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, S, S, H, H, D, 1, 0, D ** -0.5,
             BWD_FORMS.index("wgmma"), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the backward failed: CUDA error {err}")
    return dq, dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.attention import flash_attention_cuda, plan

    libs = {}
    for name, bound in VARIANTS.items():
        libs[name], report = build_variant(name, bound)
        print("build " + json.dumps({"variant": name, "launch_bound": bound,
                                     "kernel": KERNEL} | report))
    timer = chip_smoke.DeviceTimer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    same = True
    for B, S, H in SHAPES:
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        form = plan(torch.bfloat16, B, S, S, H, H, D)
        out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0,
                                        form=form, return_lse=True)
        grads = {n: backward(lib, q, k, v, out, do, lse)
                 for n, lib in libs.items()}
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(grads["one"],
                                                      grads["two"]))
        same &= equal
        ms = {n: [] for n in libs}
        for n in ("one", "two", "two", "one"):
            ms[n].append(timer(lambda lib=libs[n]: backward(
                lib, q, k, v, out, do, lse), 5 if S >= 4096 else 20))
        print("shape " + json.dumps({"B": B, "S": S, "heads": H, "D": D,
                                     "ms": ms, "equal": equal}))
    print(json.dumps({"card": chip_smoke.card_line(), "equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
