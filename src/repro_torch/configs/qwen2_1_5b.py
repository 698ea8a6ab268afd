"""Qwen2-1.5B: 28L d1536, 12H GQA(kv=2) hd128, d_ff 8960, QKV bias,
vocab 151936.  [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, d_ff=8960, vocab=151936,
    n_heads=12, n_kv_heads=2, head_dim=128, qkv_bias=True,
    rope_theta=1e6, act="swiglu", tie_embeddings=True,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=128, vocab=512,
                      n_heads=4, n_kv_heads=2, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
