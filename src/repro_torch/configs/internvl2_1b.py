"""internvl2-1b — VLM: InternViT frontend (a stub: precomputed patch
embeddings are inputs) + a qwen2-0.5b-style language decoder.
[arXiv:2404.16821]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def internvl2_1b() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151_655,
        qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0, norm="rms", act="silu_glu",
        n_patches=256,
        source="arXiv:2404.16821",
    )
