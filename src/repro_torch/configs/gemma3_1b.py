"""gemma3-1b — dense, GQA kv=1, 5:1 local:global sliding-window pattern,
head_dim=256, 262k vocab (tied embeddings). [hf:google/gemma-3-1b-pt]"""
from ..models.config import ArchConfig
from ..models.registry import register


def _pattern(n_layers: int) -> tuple[str, ...]:
    # 5 local (SWA-512) then 1 global per group of 6 (layers 5,11,17,23 global)
    return tuple("attn_global" if (i + 1) % 6 == 0 else "attn_local"
                 for i in range(n_layers))


@register
def gemma3_1b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262_144,
        block_pattern=_pattern(26), sliding_window=512,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        tie_embeddings=True, embed_scale=True, norm="rms", act="gelu_glu",
        source="hf:google/gemma-3-1b-pt",
    )
