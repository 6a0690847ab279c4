"""Architecture + input-shape configuration records.

The port's own copy of ``repro.models.config`` (the port imports nothing of
the JAX package): one ``ArchConfig`` per architecture, ``reduced()`` for the
CPU-sized variant, the ``ShapeConfig`` record the serving engines use, and
the dry run's input shapes (``SHAPES``, ``shape_supported``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_ff: int = 0                   # per-expert FFN width
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    token_chunk: int = 4096         # dispatch chunking (bounds (T,E,C) tensors)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)
    chunk: int = 256                # associative-scan chunk length


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 768
    kv_lora: int = 256
    qk_nope: int = 64
    qk_rope: int = 32
    v_head: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0             # 0 -> n_heads (MHA)
    head_dim: int = 0               # 0 -> d_model // n_heads
    block_pattern: tuple[str, ...] = ()   # () -> uniform default kind
    rope_theta: float = 10_000.0
    rope_theta_global: float = 1_000_000.0
    sliding_window: int = 0         # 0 -> full attention
    qkv_bias: bool = False
    norm: str = "rms"               # rms | ln
    act: str = "silu_glu"           # silu_glu | gelu | gelu_glu
    parallel_residual: bool = False  # GPT-NeoX style
    tie_embeddings: bool = False
    embed_scale: bool = False        # multiply embeddings by sqrt(d) (gemma)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    mla: MLAConfig | None = None
    n_patches: int = 0              # vlm: patch embeddings prepended to text
    n_frames: int = 0               # audio: encoder input frames
    enc_layers: int = 0             # enc-dec: encoder depth (decoder = n_layers)
    source: str = ""                # citation

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank(self) -> int:
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        default = {"dense": "attn", "moe": "moe", "ssm": "mamba",
                   "vlm": "attn", "audio": "dec"}[self.family] \
            if self.family != "hybrid" else "attn"
        return (default,) * self.n_layers

    def kind_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for k in self.pattern:
            out[k] = out.get(k, 0) + 1
        return out

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4, vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family/block kinds, tiny dims."""
        d_model = min(d_model, self.d_model)
        heads = min(self.n_heads, max(2, d_model // 64))
        kvh = max(1, min(self.kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        kinds = list(dict.fromkeys(self.pattern))  # preserve order, unique
        pat = tuple((kinds * n_layers)[:max(n_layers, len(kinds))])
        moe = self.moe
        if moe.n_experts:
            moe = dataclasses.replace(
                moe, n_experts=min(n_experts, moe.n_experts),
                d_ff=min(max(2 * d_model, 64), moe.d_ff), token_chunk=256)
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(q_lora=d_model // 2, kv_lora=d_model // 4,
                            qk_nope=32, qk_rope=16, v_head=32)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=len(pat),
            d_model=d_model, n_heads=heads, n_kv_heads=kvh, head_dim=0,
            d_ff=min(max(2 * d_model, 64), self.d_ff) if self.d_ff else 0,
            vocab=min(vocab, self.vocab), block_pattern=pat, moe=moe, mla=mla,
            ssm=dataclasses.replace(self.ssm, chunk=64),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            n_frames=min(self.n_frames, 32) if self.n_frames else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic support for long_500k (the reference's DESIGN
# §Arch-applicability): SSM/hybrid run natively; gemma3 (SWA local +
# seq-sharded global flash-decode) and mixtral (SWA 4k) run; pure
# full-attention archs are skipped.
LONG_CONTEXT_OK = {"falcon-mamba-7b", "jamba-v0.1-52b", "gemma3-1b",
                   "mixtral-8x7b"}


def shape_supported(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch.name in LONG_CONTEXT_OK
    return True
