"""minicpm3-4b — dense with Multi-head Latent Attention (MLA), 62 layers.
[hf:openbmb/MiniCPM3-4B]"""
from ..models.config import ArchConfig, MLAConfig
from ..models.registry import register


@register
def minicpm3_4b() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73448,
        block_pattern=("mla",) * 62,
        mla=MLAConfig(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
                      v_head=64),
        norm="rms", act="silu_glu",
        source="hf:openbmb/MiniCPM3-4B",
    )
