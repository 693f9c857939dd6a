"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, window=4096,
    rope_theta=1e6, tie_embeddings=False, modality="moe",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
    n_experts=4, top_k=2, window=16, capacity_factor=8.0,
    tie_embeddings=False, modality="moe", loss_chunk=16,
)
