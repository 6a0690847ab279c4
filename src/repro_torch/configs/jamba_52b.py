"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave (attention at layer
index 4 of each 8-layer Jamba block), MoE (16e top-2) every other layer.
Attention layers use no positional encoding (Jamba design).
[arXiv:2403.19887]"""
from ..models.config import ArchConfig, MoEConfig, SSMConfig
from ..models.registry import register


def _pattern(n_layers: int = 32) -> tuple[str, ...]:
    out = []
    for i in range(n_layers):
        mixer = "attn" if i % 8 == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        out.append(f"{mixer}_{ffn}")
    return tuple(out)


@register
def jamba_52b() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        block_pattern=_pattern(32),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        norm="rms", act="silu_glu",
        source="arXiv:2403.19887",
    )
