"""smollm-360m [dense] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-360M; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
    rope_theta=1e4, tie_embeddings=True, modality="dense",
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=160, vocab=128,
    tie_embeddings=True, modality="dense", loss_chunk=16,
)
