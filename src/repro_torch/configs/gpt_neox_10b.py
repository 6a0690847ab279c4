"""gpt-neox-10b — the paper's second evaluation size (a 10B GPT-NeoX-style
config; the paper does not publish exact dims, we use 32L x 5120, a standard
~10.9B GPT shape; 40 heads of 128). [paper §VI Figs 8/9]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def gpt_neox_10b() -> ArchConfig:
    return ArchConfig(
        name="gpt-neox-10b", family="dense",
        n_layers=32, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=20480, vocab=50_432,
        block_pattern=("neox",) * 32,
        parallel_residual=True, norm="ln", act="gelu",
        source="paper §VI (assumed dims)",
    )
