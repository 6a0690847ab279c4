"""gpt-neox-20b — the paper's primary evaluation model (GPT-NeoX 20B:
44 layers, d=6144, 64 heads, parallel residual, LayerNorm, GELU MLP).
[Black et al. 2022, paper §VI]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def gpt_neox_20b() -> ArchConfig:
    return ArchConfig(
        name="gpt-neox-20b", family="dense",
        n_layers=44, d_model=6144, n_heads=64, n_kv_heads=64,
        d_ff=24576, vocab=50_432,
        block_pattern=("neox",) * 44,
        parallel_residual=True, norm="ln", act="gelu",
        source="arXiv:2204.06745 (paper Figs 7/10)",
    )
