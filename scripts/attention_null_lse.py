#!/usr/bin/env python3
"""The flash-attention forward with and without an lse buffer, bit for
bit against another tree's kernel (a parent commit's), and with a null
device length.

    python3 scripts/attention_null_lse.py --parent build/parent/src

Needs one CUDA card and `nvcc`.  `--parent` is the `src/` of the other
tree (unpack it with `git archive <commit> src | tar -x -C build/parent`),
one whose kernel writes the lse (PR 20 on); its `csrc/flash_attention.cu`
(with the headers beside it) is built here into `build/` and called
through its own C entry, with a null lse and with an lse buffer.  For
every form (tile, wgmma, split), both dtypes and each head_dim the form
takes, the serving launch (`ops.flash_attention`, lse null) and the
training launch (the same kernel writing the lse) must equal the other
tree's output bit for bit, and the two trees' lse must be equal.  A
tree whose C entry takes a device length (the split form's `len`) is
called with a null one there: the int form, which must not have moved.
Prints one JSON line per case and exits non-zero on any difference.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (B, Sq, Sk, Hq, Hk, D, causal): prefill on the tile and wgmma forms,
# decode (Sq = 1) on the split form, ragged lengths, q_offset via Sq < Sk.
CASES = [(2, 300, 300, 16, 8, 128, True), (1, 65, 130, 4, 2, 64, True),
         (1, 70, 70, 8, 1, 256, True), (1, 33, 70, 8, 2, 16, False),
         (2, 64, 64, 4, 2, 32, True), (4, 1, 1025, 16, 8, 128, True),
         (2, 1, 40, 4, 4, 32, True), (2, 4096, 4096, 16, 8, 128, True)]


def build_parent(parent_src: Path):
    """(the other tree's library, whether its C entry takes a device
    length after the lse)."""
    from repro_torch.kernels import build
    src = parent_src / "repro_torch" / "csrc" / "flash_attention.cu"
    out = build.BUILD_DIR / "libflash_attention-parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    entry = src.read_text().split('extern "C" int flash_attention_f32(')[1]
    return ctypes.CDLL(str(out)), "const void* len" in entry.split(")")[0]


def parent_forward(parent, q, k, v, causal, off, form, with_lse):
    """The other tree's (out, lse), lse None for a serving launch."""
    from repro_torch.kernels.attention import _ARGTYPES, FORMS
    lib, takes_len = parent
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = getattr(lib, "flash_attention_f32" if q.dtype == torch.float32
                 else "flash_attention_bf16")
    fn.argtypes = _ARGTYPES if takes_len else _ARGTYPES[:5] + _ARGTYPES[6:]
    fn.restype = ctypes.c_int
    length = (None,) if takes_len else ()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *length, B, Sq, Sk,
             Hq, Hk, D, int(causal), off, D ** -0.5, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             FORMS.index(form.form), form.splits,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's kernel failed: CUDA error {err}")
    return out, lse


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the other tree's src/ directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import flash_attention_cuda, plan

    parent = build_parent(Path(args.parent))
    print(f"the other tree's entry takes a device length: {parent[1]}")
    gen = torch.Generator().manual_seed(0)
    bad = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Sk, Hq, Hk, D, causal in CASES:
            q = torch.randn((B, Sq, Hq, D), generator=gen).to("cuda", dtype)
            k = torch.randn((B, Sk, Hk, D), generator=gen).to("cuda", dtype)
            v = torch.randn((B, Sk, Hk, D), generator=gen).to("cuda", dtype)
            off = Sk - Sq
            form = plan(dtype, B, Sq, Sk, Hq, Hk, D)
            want = parent_forward(parent, q, k, v, causal, off, form,
                                  False)[0]
            want_train, want_lse = parent_forward(parent, q, k, v, causal,
                                                  off, form, True)
            serve = ops.flash_attention(q, k, v, causal=causal)
            train, lse = flash_attention_cuda(q, k, v, causal=causal,
                                              q_offset=off, form=form,
                                              return_lse=True)
            torch.cuda.synchronize()
            row = {"dtype": str(dtype).split(".")[1],
                   "shape": [B, Sq, Sk, Hq, Hk, D], "causal": causal,
                   "form": form.form, "splits": form.splits,
                   "null_lse_equal": torch.equal(serve, want),
                   "with_lse_equal": torch.equal(train, want)
                   and torch.equal(train, want_train),
                   "lse_equal": torch.equal(lse, want_lse)}
            bad += not (row["null_lse_equal"] and row["with_lse_equal"]
                        and row["lse_equal"])
            print("case " + json.dumps(row))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"cases": 2 * len(CASES), "differ": bad, "card": card}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
