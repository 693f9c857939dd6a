"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8, d_head=256) d_ff=14336 vocab=256000
[arXiv:2408.00118; hf].  Local layers use a 4096 sliding window; attention
logits capped at 50, final logits at 30; pre+post RMSNorms; GeGLU FFN.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab=256000,
    ffn_type="geglu", attn_softcap=50.0, final_softcap=30.0,
    window=4096, local_global_period=2, post_norm=True,
    rope_theta=1e4, tie_embeddings=True, modality="dense",
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, ffn_type="geglu", attn_softcap=50.0, final_softcap=30.0,
    window=16, local_global_period=2, post_norm=True, tie_embeddings=True,
    modality="dense", loss_chunk=16,
)
