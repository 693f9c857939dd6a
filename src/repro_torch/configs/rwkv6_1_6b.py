"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified].
32 WKV heads of dim 64.  CARLA applicability: the WKV recurrence has no conv
structure (DESIGN.md §5); the 2-tap token shift uses the CARLA conv1d
dataflow; all projections use the dual-stationarity GEMM planner.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    block_type="rwkv6", tie_embeddings=True, modality="ssm",
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=128,
    block_type="rwkv6", tie_embeddings=True, modality="ssm", loss_chunk=16,
)
