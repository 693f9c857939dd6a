"""smollm-135m [dense] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152,
    rope_theta=1e4, tie_embeddings=True, modality="dense",
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128, vocab=128,
    tie_embeddings=True, modality="dense", loss_chunk=16,
)
