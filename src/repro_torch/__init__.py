"""EcoFlow zero-free convolutions, and the dense decoder LM served beside
them, in PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(sm_90a).

The package mirrors `repro`'s layout module for module, so
`repro_torch/kernels/tconv_phase.py` is the counterpart of
`repro/kernels/tconv_phase.py`.  Public layout is `repro`'s: activations
NHWC, filters HWIO `(Kh, Kw, Cin, Cout)`, attention operands
(B, S, heads, head_dim).  Entry points run on `cuda`
unless the caller passes `device="cpu"`; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead of the kernel.
"""
