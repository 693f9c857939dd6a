"""llama4-maverick-400b-a17b [moe] — interleaved MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1
with one shared expert on every other layer (moe_period=2), matching the
~400B-total / ~17B-active parameterization
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, moe_period=2, n_shared_experts=1,
    rope_theta=5e5, tie_embeddings=False, modality="moe",
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
    n_experts=4, top_k=1, moe_period=2, n_shared_experts=1,
    capacity_factor=8.0, tie_embeddings=False, modality="moe", loss_chunk=16,
)
