#!/usr/bin/env python3
"""Device time of each role of the fused conv backwards, alone, at the nine
main-path layers of conv training and at the vision layers.

    python3 scripts/backward_roles.py [--src DIR] [--tag NAME] [--out FILE]
                                      [--layers all|main|vision]
                                      [--dtype float32|bfloat16]

Needs one CUDA card and `nvcc`.  The roles of `csrc/conv_backward.cu` and
`csrc/tconv_backward.cu` (dW, db, dx / ddy) share one launch, so no
committed switch runs one alone.  This script copies the `repro_torch`
package's `csrc` (from `--src`, by default this checkout's `src`; another
one, such as an unpacked earlier commit, times that commit's kernels)
into `build/roles/<tag>/`, edits the copies of the two sources so that the C
entry launches only the role named by the environment variable
`ROLE_ONLY` (the other roles' CTA counts set to 0), builds them there,
and times, per layer: the whole launch, each role alone, and the
library (cuDNN, TF32 off) -- CUDA events over 20 launches behind a spin
kernel (`chip_smoke.DeviceTimer`), on operands of `--dtype` (the
library's too).  The vision layers (patchify's S = K =
14 conv and the atrous head's 1x1 fuse, `models/vision.py`) also time
their forward (`csrc/dconv_forward.cu`) against cuDNN's.  One JSON line
per layer, then the card's name and power limit.  To time an earlier
commit's kernels, unpack its `src` and point `--src` at it:

    git archive <commit> src | tar -x -C build/parent
    python3 scripts/backward_roles.py --src build/parent/src --tag parent

The edit looks for the role counts by name: `n_dw`, `n_db` and the
dx / ddy count (`n_dx`, or the older `dx_tiles` / `n_ddy`).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# The nine main-path layers at batch 64: (kernel, name, g-side or x-side
# (H, W), Cin, Cout, K, activation).
LAYERS = [("conv_backward", "disc_c1", (32, 32), 3, 32, 4, "leaky_relu"),
          ("conv_backward", "disc_c2", (16, 16), 32, 64, 4, "leaky_relu"),
          ("conv_backward", "disc_c3", (8, 8), 64, 128, 4, "leaky_relu"),
          ("conv_backward", "cnn_l1", (32, 32), 3, 32, 3, "relu"),
          ("conv_backward", "cnn_l2", (16, 16), 32, 64, 3, "relu"),
          ("conv_backward", "cnn_l3", (8, 8), 64, 128, 3, "relu"),
          ("tconv_backward", "gan_t1", (8, 8), 64, 128, 4, "relu"),
          ("tconv_backward", "gan_t2", (16, 16), 32, 64, 4, "relu"),
          ("tconv_backward", "gan_t3", (32, 32), 3, 32, 4, "tanh")]
BATCH = 64
# The vision layers: (kernel, name, batch, x side (H, W), Cin, Cout, K, S,
# P, activation) -- patchify (InternViT's entry, d_model 1024, smoke phase
# 8 (b)) and the atrous head's 1x1 fuse (48 -> 4 classes, phase 8 (a)),
# both without an epilogue.
VISION_LAYERS = [
    ("conv_backward", "patchify", 8, (448, 448), 3, 1024, 14, 14, 0, None),
    ("conv_backward", "atrous_fuse", 16, (128, 128), 48, 4, 1, 1, 0, None)]
ROLES = ("dw", "db", "dx")


def layer_rows(which: str = "all") -> list:
    """(kernel, name, batch, side, Cin, Cout, K, S, P, activation) of the
    main-path layers (S = 2, P = 1, batch 64), the vision layers, or
    both ("all")."""
    rows = [(kernel, name, BATCH, hw, cin, cout, k, 2, 1, act)
            for kernel, name, hw, cin, cout, k, act in LAYERS] \
        if which != "vision" else []
    return rows + (VISION_LAYERS if which != "main" else [])


def scratch_sources(csrc: Path, dest: Path) -> None:
    """Copy `csrc` to `dest` with the two backward entries gated by
    ROLE_ONLY."""
    if dest.exists():
        shutil.rmtree(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.copytree(csrc, dest)
    for name in ("conv_backward.cu", "tconv_backward.cu"):
        path = dest / name
        src = path.read_text()
        names = [n for n in ("n_dw", "n_db", "n_dx", "dx_tiles", "n_ddy")
                 if re.search(rf"const long long {n}\b", src)]
        for n in names:
            src = re.sub(rf"const long long {n}\b", f"long long {n}", src)
        # The gate goes right after the last of the counts' definitions.
        last = max(src.index(";", src.index(f"long long {n}")) for n in names)
        gate = "".join(
            f"  if (__r && strcmp(__r, \"{role}\") != 0) {n} = 0;\n"
            for n in names
            for role in [{"n_dw": "dw", "n_db": "db"}.get(n, "dx")])
        src = (src[:last + 1] + "\n  { const char* __r = getenv(\"ROLE_ONLY\");"
               "\n" + gate + "  }\n" + src[last + 1:])
        src = "#include <cstdlib>\n#include <cstring>\n" + src
        path.write_text(src)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--tag", default="this", help="names the build and lines")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--layers", choices=("all", "main", "vision"),
                    default="all", help="which layers to time")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the operands' dtype")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("backward_roles: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.kernels import build, ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = ROOT / "build" / "roles" / args.tag
    scratch_sources(build.CSRC, work / "csrc")
    build.CSRC, build.BUILD_DIR = work / "csrc", work / "lib"
    build.build(["conv_backward", "tconv_backward", "dconv_forward"])
    dev = torch.device("cuda")
    timer = chip_smoke.DeviceTimer()
    gen = torch.Generator().manual_seed(0)
    dtype = getattr(torch, args.dtype)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    lines = []
    for kernel, name, batch, hw, cin, cout, k, s, p, act in layer_rows(
            args.layers):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k)
        ep = Epilogue(activation=act or "none", slope=0.2)
        oh_ow = spec.out_size(hw)
        w = rand(k, k, cin, cout)
        w_lib = w.permute(3, 2, 0, 1).contiguous()
        big = rand(batch, *hw, cin)
        small = rand(batch, *oh_ow, cout) / math.sqrt(batch * oh_ow[0]
                                                      * oh_ow[1])
        geo = dict(stride=spec.stride, padding=spec.padding,
                   dilation=spec.dilation)
        fwd = None
        if kernel == "conv_backward":
            y = None if act is None else \
                torch.nn.functional.leaky_relu(rand(*small.shape), 0.2) \
                if act == "leaky_relu" else torch.relu(rand(*small.shape))

            def run():
                return ops.conv_backward(big, small, w, n_out=hw, y=y,
                                         epilogue=ep, **geo)

            def lib():
                m = small if y is None else ep.mask_cotangent(y, small)
                m = m.permute(0, 3, 1, 2)
                return (torch.nn.grad.conv2d_input(
                            (batch, cin, *hw), w_lib, m, **geo),
                        torch.nn.grad.conv2d_weight(
                            big.permute(0, 3, 1, 2), w_lib.shape, m, **geo))

            if act is None:      # a vision layer: its forward too
                fwd = (lambda: ops.dconv_forward(big, w, **geo),
                       lambda: torch.nn.functional.conv2d(
                           big.permute(0, 3, 1, 2), w_lib, **geo))
        else:
            z = torch.tanh(rand(*big.shape)) if act == "tanh" \
                else torch.relu(rand(*big.shape))

            def run():
                return ops.tconv_backward(big, small, w, z=z, epilogue=ep,
                                          **geo)

            def lib():
                m = ep.mask_cotangent(z, big).permute(0, 3, 1, 2)
                return (torch.nn.functional.conv2d(m, w_lib, **geo),
                        torch.nn.grad.conv2d_weight(
                            m, w_lib.shape, small.permute(0, 3, 1, 2),
                            **geo))
        row = {"tag": args.tag, "kernel": kernel, "layer": name,
               "batch": batch, "dtype": args.dtype}
        os.environ.pop("ROLE_ONLY", None)
        row["launch_ms"] = timer(run)
        for role in ROLES:
            os.environ["ROLE_ONLY"] = role
            row[f"{role}_ms"] = timer(run)
        os.environ.pop("ROLE_ONLY", None)
        row["library_ms"] = timer(lib)
        if fwd is not None:
            row["fwd_ms"], row["fwd_library_ms"] = timer(fwd[0]), \
                timer(fwd[1])
        lines.append("roles " + json.dumps(row))
        print(lines[-1], flush=True)
    card = chip_smoke.card_line()
    lines.append(card)
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
