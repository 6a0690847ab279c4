"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA kv=8, LayerNorm.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from ..models.config import ArchConfig, MoEConfig
from ..models.registry import register


@register
def phi35_moe() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400),
        rope_theta=10_000.0, norm="ln", act="silu_glu",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
