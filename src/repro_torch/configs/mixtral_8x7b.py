"""mixtral-8x7b — 8-expert top-2 MoE, GQA kv=8, sliding-window 4096.
[arXiv:2401.04088]"""
from ..models.config import ArchConfig, MoEConfig
from ..models.registry import register


@register
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
        sliding_window=4096,
        rope_theta=1_000_000.0, norm="rms", act="silu_glu",
        source="arXiv:2401.04088",
    )
