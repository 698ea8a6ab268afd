"""RWKV6 (Finch) 7B: 32L d4096, attn-free, data-dependent per-channel
decay, head_size 64 (64 heads), channel-mix d_ff 14336, vocab 65536.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    ssm_head_dim=64, chunk_size=16,
    tie_embeddings=False,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=224, vocab=512,
                      ssm_head_dim=16, loss_chunk=32)
