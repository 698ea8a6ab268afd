"""Qwen3-0.6B: 28L d1024, 16H GQA(kv=8) hd128, d_ff 3072, vocab 151936,
qk_norm.  [hf:Qwen/Qwen3-0.6B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, d_ff=3072, vocab=151936,
    n_heads=16, n_kv_heads=8, head_dim=128, qk_norm=True,
    rope_theta=1e6, act="swiglu", tie_embeddings=True,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=128, vocab=512,
                      n_heads=4, n_kv_heads=2, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
