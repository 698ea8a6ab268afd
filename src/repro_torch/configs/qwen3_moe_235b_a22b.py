"""Qwen3-MoE-235B-A22B: 94L d4096, 64H GQA(kv=4) hd128, MoE 128e top-8
d_ff_expert=1536, vocab 151936, qk_norm.  [hf:Qwen/Qwen3-235B-A22B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, d_ff=1536, vocab=151936,
    n_heads=64, n_kv_heads=4, head_dim=128, qk_norm=True,
    rope_theta=1e6, act="swiglu",
    n_experts=128, top_k=8, moe_dff=1536,
    tie_embeddings=False,
    microbatch=16,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=96, vocab=512,
                      n_heads=4, n_kv_heads=2, head_dim=16,
                      n_experts=8, top_k=2, moe_dff=96, capacity_factor=4.0,
                      attn_chunk=32, loss_chunk=32)
