"""InternVL2-Llama3-76B language backbone: 80L d8192, 64H GQA(kv=8) hd128,
d_ff 28672, vocab 128256.  The InternViT frontend is a STUB: the model
takes precomputed patch embeddings (B,S,D); the patchify module itself
(stride-14 conv with EcoFlow zero-free backward) lives in
`models/vision.py`.  [arXiv:2404.16821; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, d_ff=28672, vocab=128256,
    n_heads=64, n_kv_heads=8, head_dim=128,
    rope_theta=5e5, act="swiglu", embed_input=True,
    tie_embeddings=False,
    microbatch=16,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=128, vocab=512,
                      n_heads=4, n_kv_heads=2, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
