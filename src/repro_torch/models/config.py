"""Model configuration shared by all assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads

    # block composition
    block_type: str = "attn"         # "attn" | "rwkv6" | "mamba2"
    ffn_type: str = "swiglu"         # "swiglu" | "geglu" | "gelu"

    # attention flavor
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE
    attn_softcap: float = 0.0        # gemma2
    final_softcap: float = 0.0       # gemma2
    window: int = 0                  # sliding window (mixtral SWA, gemma2 local)
    local_global_period: int = 0     # gemma2: alternate local/global layers
    post_norm: bool = False          # gemma2 post-norms

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1              # llama4: MoE every 2nd layer
    n_shared_experts: int = 0        # llama4 shared expert
    capacity_factor: float = 1.25    # GShard capacity (smoke: 8 = dropless)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    hybrid_attn_period: int = 0      # zamba2: shared attn block every N layers

    # embeddings / IO
    tie_embeddings: bool = True
    input_mode: str = "tokens"       # "tokens" | "embeds" (stubbed frontends)

    # numerics / training
    norm_eps: float = 1e-6
    remat: bool = True
    loss_chunk: int = 512            # chunked cross-entropy (bounds logit memory)
    modality: str = "text"           # doc tag: text|audio|vlm|moe|ssm|hybrid

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        """Layers per scanned group (static heterogeneity lives in the group)."""
        if self.block_type == "attn":
            g = 1
            if self.is_moe and self.moe_period > 1:
                g = max(g, self.moe_period)
            if self.local_global_period > 1:
                g = max(g, self.local_global_period)
            return g
        if self.block_type == "mamba2" and self.hybrid_attn_period > 0:
            return self.hybrid_attn_period
        return 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"group_size={self.group_size}")
        return self.n_layers // self.group_size

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D MODEL_FLOPS)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        if self.block_type == "attn":
            attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
            dense_ffn = d * dff * (3 if self.ffn_type in ("swiglu", "geglu") else 2)
            if self.is_moe:
                moe_ffn = self.n_experts * d * dff * 3 + d * self.n_experts
                if self.n_shared_experts:
                    moe_ffn += self.n_shared_experts * d * dff * 3
                n_moe_layers = self.n_layers // self.moe_period
                n_dense_layers = self.n_layers - n_moe_layers
                per_layer_ffn = 0  # accounted below
                total_ffn = n_moe_layers * moe_ffn + n_dense_layers * dense_ffn
            else:
                total_ffn = self.n_layers * dense_ffn
            return n_emb + self.n_layers * attn + total_ffn
        if self.block_type == "rwkv6":
            per_layer = d * d * 5 + d * 4 * d * 2 + d * d  # time+channel mix
            return n_emb + self.n_layers * per_layer
        if self.block_type == "mamba2":
            d_inner = 2 * d
            per_layer = d * (2 * d_inner + 2 * self.ssm_state) + d_inner * d
            n_param = n_emb + self.n_layers * per_layer
            if self.hybrid_attn_period:
                attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
                n_param += attn + d * dff * 3  # one shared block
            return n_param
        raise ValueError(self.block_type)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.is_moe:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        full_experts = self.n_experts * d * dff * 3
        active_experts = (self.top_k + self.n_shared_experts) * d * dff * 3
        n_moe_layers = self.n_layers // self.moe_period
        return self.param_count() - n_moe_layers * (full_experts - (
            self.top_k * d * dff * 3))
