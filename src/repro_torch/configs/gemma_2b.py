"""Gemma-2B: 18L d2048, 8H MQA(kv=1) hd256, GeGLU d_ff 16384,
vocab 256000.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, d_ff=16384, vocab=256000,
    n_heads=8, n_kv_heads=1, head_dim=256,
    rope_theta=1e4, act="geglu", tie_embeddings=True,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=256, vocab=512,
                      n_heads=4, n_kv_heads=1, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
