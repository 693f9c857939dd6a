"""zamba2-2.7b [hybrid] — Mamba2 backbone + one shared attention block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  The shared attention+FFN block (single weight set)
is applied after every 6 Mamba2 blocks (9 applications over 54 layers), with
per-application KV caches.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000,
    block_type="mamba2", ssm_state=64, ssm_head_dim=64, d_conv=4,
    hybrid_attn_period=6, tie_embeddings=True, modality="hybrid",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab=128, block_type="mamba2", ssm_state=16, ssm_head_dim=32,
    hybrid_attn_period=2, tie_embeddings=True, modality="hybrid",
    loss_chunk=16,
)
