"""deepseek-7b — llama-arch dense MHA. [arXiv:2401.02954]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def deepseek_7b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102_400,
        rope_theta=10_000.0, norm="rms", act="silu_glu",
        source="arXiv:2401.02954",
    )
