"""Build the CUDA kernels of `repro_torch/csrc/` and load them with ctypes.

Each `.cu` file has a plain C interface (no PyTorch headers), so `nvcc`
builds it in seconds into `<repo>/build/`.  Each conv kernel has one C
entry per operand dtype, `<name>_f32` and `<name>_bf16` (`symbol`), both
built from the same source, the same templates instantiated for `float`
and `__nv_bfloat16`.  A library's file name carries
a hash of its sources and flags: an edited kernel is rebuilt, never
loaded stale.  Nothing builds at import -- only on a kernel's first
launch, or through `build()`, which starts one `nvcc` per source, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("dconv_forward", "tconv_phase", "implicit_gemm", "conv_backward",
           "tconv_backward", "dconv_filtergrad", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# The conv kernels' operand dtypes and their C entries' suffixes.
CONV_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda_home / "bin" / "nvcc").exists():
        return str(cuda_home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Where the library of source `name` lives for its current text."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in `names` that has no library yet, one `nvcc`
    process per source, all started together.  Returns each source's
    compiler output (registers and spills from `-Xptxas=-v`; '' when the
    library already existed).  Raises RuntimeError naming every source
    that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: Dict[str, str] = {}
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            logs[name] = ""
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `symbol` of source `name`, built on first use.  Every
    entry returns the launch's cudaGetLastError() as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def symbol(base: str, dtype: torch.dtype) -> str:
    """The C entry of conv kernel `base` for operands of `dtype`:
    `<base>_f32` or `<base>_bf16`."""
    return f"{base}_{CONV_DTYPES[dtype]}"


def widened(*tensors):
    """Each tensor in fp32 (None stays None): a conv kernel's operands as
    its plain version sums them, every bf16 element widened exactly, so
    it accumulates in fp32 as the kernel does; an fp32 tensor is returned
    as it is."""
    return tuple(None if t is None else t.float() for t in tensors)


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry reported a CUDA error: a refused launch
    never runs, and a later synchronize would not report it."""
    if err != 0:
        msg = _LIBS[name].cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


_ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}


def epilogue_args(epilogue) -> tuple:
    """(act, slope, has_scale, scale) of the kernels' EpilogueArgs."""
    if epilogue is None:
        return 0, 0.0, 0, 1.0
    has_scale = epilogue.scale is not None
    return (_ACT_CODES[epilogue.activation], float(epilogue.slope),
            int(has_scale), float(epilogue.scale) if has_scale else 1.0)
