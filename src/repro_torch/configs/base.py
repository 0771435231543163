"""Config dataclasses for the model zoo, shapes, and execution policies.

Every assigned architecture is expressed as a ``ModelConfig``; shape cells
(``train_4k`` etc.) are ``ShapeConfig``; dtype and sharding behaviour are
policies attached to the config so the dry-run can override them per arch
(e.g. FSDP + bf16 optimizer state for the >100B models).

A copy of the reference's ``repro.configs.base``, so that this package
never imports ``repro``. The sharding policies are carried as data; the
port has no sharding yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    num_shared: int = 0              # shared (always-on) experts
    top_k: int = 2
    d_ff_expert: int = 0             # per-expert hidden dim
    capacity_factor: float = 1.25
    # layers that are MoE; "every" = all, "alternate" = odd layers,
    # "dense_first_k" = all but the first k layers (deepseek style)
    layout: str = "every"
    dense_first_k: int = 0
    d_ff_shared: int = 0             # hidden dim of shared-expert block
    router_dtype: str = "float32"
    # dispatch implementation: "scatter" = GShard-style dense scatter
    # (baseline), "gather" = index-scatter + sharded gathers (optimized:
    # the big buffers move as expert-sharded gathers, not all-reduces)
    dispatch: str = "scatter"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64               # P
    chunk_size: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper). Frontend is a stub: inputs are
    precomputed frame embeddings of shape [B, n_frames, d_model]."""
    n_layers: int = 4
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """VLM patch-embedding stub: input_specs provides [B, n_patches, d_model]
    precomputed patch embeddings spliced into the token sequence."""
    n_patches: int = 256


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # optimizer moments dtype; ">=100B" archs use bf16 to fit HBM
    opt_dtype: str = "float32"


@dataclass(frozen=True)
class ShardingPolicy:
    """Logical-axis -> mesh-axis mapping policy.

    data axes ('pod','data') shard the batch; 'model' shards tensor dims.
    fsdp=True additionally shards the largest param dim over the data axes
    (ZeRO-3 style) — required for the >=100B archs to fit 16GB/chip.
    """
    fsdp: bool = False
    shard_experts: bool = True       # experts over 'model' axis
    zero1: bool = True               # optimizer state sharded over data axes
    # decode-cache context parallelism: shard the cache SEQ dim over
    # 'model' when kv-heads don't divide the axis (qwen/phi3-style GQA)
    cache_seq_shard: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # rope
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm3 "2d rope": 0.5
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0      # jamba: 8 -> 1 attn layer per 8
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    mtp: bool = False                # deepseek-v3 multi-token-prediction head
    dtype: DTypePolicy = field(default_factory=DTypePolicy)
    sharding: ShardingPolicy = field(default_factory=ShardingPolicy)
    # set True for archs with sub-quadratic sequence mixing (run long_500k)
    subquadratic: bool = False
    # chunked online-softmax attention block (0 = naive S x S baseline)
    attn_chunk_q: int = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = {}
        kw["n_layers"] = min(self.n_layers, 4 if self.hybrid_attn_period == 0
                             else self.hybrid_attn_period)
        kw["d_model"] = 64
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(self.n_kv_heads, 2)) \
            if self.n_kv_heads < self.n_heads else 4
        kw["d_ff"] = 128
        kw["vocab_size"] = 256
        kw["head_dim"] = 16
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                d_ff_shared=64 if self.moe.num_shared else 0,
                dense_first_k=min(self.moe.dense_first_k, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk_size=32)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(n_layers=2, n_frames=16)
        if self.vision is not None:
            kw["vision"] = VisionConfig(n_patches=8)
        if self.hybrid_attn_period:
            kw["n_layers"] = self.hybrid_attn_period  # one full period
        kw["dtype"] = DTypePolicy(param_dtype="float32",
                                  compute_dtype="float32")
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def optimized(cfg: "ModelConfig") -> "ModelConfig":
    """The beyond-paper performance variant (EXPERIMENTS.md SPerf):
    chunked attention, gather-based MoE dispatch, cache context sharding.
    The unmodified config is the recorded baseline."""
    kw = {"attn_chunk_q": 1024,
          "sharding": dataclasses.replace(cfg.sharding,
                                          cache_seq_shard=True)}
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, dispatch="gather")
    return dataclasses.replace(cfg, **kw)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def shape_cells(cfg: ModelConfig):
    """The shape cells that apply to this arch (assignment rules)."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        cells.append(LONG_500K)
    return cells
