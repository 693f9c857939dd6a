"""granite-3-2b [dense] — GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
    rope_theta=1e6, tie_embeddings=True, modality="dense",
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    tie_embeddings=True, modality="dense", loss_chunk=16,
)
