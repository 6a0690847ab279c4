"""qwen2-0.5b — dense, GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def qwen2_05b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151_936,
        qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0, norm="rms", act="silu_glu",
        source="arXiv:2407.10671",
    )
