"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec frontend is a stub: input_specs() provides precomputed frame
embeddings (input_mode="embeds"); the LM head predicts codebook tokens.
MusicGen's decoder uses non-gated GELU FFNs.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    ffn_type="gelu", rope_theta=1e4,
    tie_embeddings=True, input_mode="embeds", modality="audio",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    ffn_type="gelu", tie_embeddings=True, input_mode="embeds",
    modality="audio", loss_chunk=16,
)
