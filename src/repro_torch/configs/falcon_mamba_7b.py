"""falcon-mamba-7b — attention-free Mamba-1 SSM, 64 layers, ssm_state=16.
[arXiv:2410.05355]"""
from ..models.config import ArchConfig, SSMConfig
from ..models.registry import register


@register
def falcon_mamba_7b() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, d_ff=0, vocab=65024,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=True, norm="rms",
        source="arXiv:2410.05355",
    )
