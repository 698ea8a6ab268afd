"""Zamba2-2.7B: 54 Mamba2 blocks d2560 (d_inner 5120, heads 80 x hd64,
ssm_state 64, conv k4) + one shared-weight attention block (32H MHA hd80,
d_ff 10240) applied every 6 Mamba blocks, vocab 32000.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, d_ff=10240, vocab=32000,
    n_heads=32, n_kv_heads=32, head_dim=80,
    rope_theta=1e4, act="geglu",
    ssm_state=64, ssm_heads=80, ssm_head_dim=64, ssm_conv=4, ssm_expand=2,
    chunk_size=16, attn_every=6, tie_embeddings=True,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, d_ff=128, vocab=512,
                      n_heads=4, n_kv_heads=4, head_dim=16,
                      ssm_state=16, ssm_head_dim=16, attn_every=2,
                      attn_chunk=32, loss_chunk=32)
