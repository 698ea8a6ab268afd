"""MusicGen-medium backbone: 48L d1536, 24H MHA(kv=24) hd64, d_ff 6144
(gelu), vocab 2048 (EnCodec codebook).  The EnCodec frontend is a STUB:
the model takes precomputed frame embeddings (B,S,D).
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, d_ff=6144, vocab=2048,
    n_heads=24, n_kv_heads=24, head_dim=64,
    rope_theta=1e4, act="gelu", embed_input=True,
    tie_embeddings=False,
    microbatch=4,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=128, vocab=256,
                      n_heads=4, n_kv_heads=4, head_dim=16,
                      attn_chunk=32, loss_chunk=32)
