"""whisper-medium — encoder-decoder, conv/mel frontend STUB (precomputed frame
embeddings are inputs), 24+24 layers. Positions are sinusoidal (adaptation:
the HF checkpoint uses learned decoder positions; synthetic stress shapes
exceed its 448-position table). [arXiv:2212.04356]"""
from ..models.config import ArchConfig
from ..models.registry import register


@register
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51_865,
        block_pattern=("dec",) * 24, enc_layers=24, n_frames=1500,
        norm="ln", act="gelu", qkv_bias=True,
        source="arXiv:2212.04356",
    )
