"""Moonshot/Moonlight-16B-A3B: 48L d2048, 16H MHA(kv=16) hd128, MoE 64e
top-6 d_ff_expert=1408 + 2 shared experts, vocab 163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, d_ff=1408, vocab=163840,
    n_heads=16, n_kv_heads=16, head_dim=128,
    rope_theta=5e4, act="swiglu",
    n_experts=64, top_k=6, moe_dff=1408, n_shared_experts=2,
    tie_embeddings=False,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=96, vocab=512,
                      n_heads=4, n_kv_heads=4, head_dim=16,
                      n_experts=8, top_k=2, moe_dff=96, n_shared_experts=1, capacity_factor=4.0,
                      attn_chunk=32, loss_chunk=32)
