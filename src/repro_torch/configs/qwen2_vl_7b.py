"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191; hf].
Vision frontend stubbed (input_mode="embeds": precomputed patch embeddings).
M-RoPE sections (16, 24, 24) over d_head/2=64 rotary frequencies.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    rope_theta=1e6, mrope_sections=(16, 24, 24),
    tie_embeddings=False, input_mode="embeds", modality="vlm",
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=128,
    mrope_sections=(2, 3, 3), tie_embeddings=False, input_mode="embeds",
    modality="vlm", loss_chunk=16,
)
