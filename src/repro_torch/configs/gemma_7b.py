"""Gemma-7B: 28L d3072, 16H MHA(kv=16) hd256, GeGLU d_ff 24576,
vocab 256000.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, d_ff=24576, vocab=256000,
    n_heads=16, n_kv_heads=16, head_dim=256,
    rope_theta=1e4, act="geglu", tie_embeddings=True,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=256, vocab=512,
                      n_heads=4, n_kv_heads=4, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
